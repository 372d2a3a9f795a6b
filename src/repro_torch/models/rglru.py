"""RG-LRU recurrent block (recurrentgemma-2b / Griffin [arXiv:2402.19427]).

Counterpart: ``repro/models/rglru.py`` (``rglru_init``, ``rglru_mix``):

    r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_x x_t + b_x)
    a_t = exp(c * r_t * log(a_hat)),  log(a_hat) = -softplus(Lambda), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

inside the Griffin recurrent block: two linear branches (D -> W), a causal
conv (width 4) on the recurrent one, the RG-LRU, and a GELU-gated output
projection (W -> D).  The gate arithmetic and the recurrence run as one
kernel, ``rglru_gated`` (``kernels/rglru_scan``), in a multi-token call
(prefill, from a zero state) and in a one-token call (decode, from the
cached state) alike.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.kernels.rglru_scan.ops import rglru_gated
from repro_torch.kernels.rglru_scan.ref import C
from repro_torch.models.common import (BATCH, HEADS, SEQ, act_fn,
                                       channelwise, dense_init, gathered,
                                       param, pspec, shard)
from repro_torch.models.mamba import causal_conv, conv_history


def rglru_param_specs(cfg) -> Dict:
    """The reference's ``rglru_param_specs``: the recurrence's channels
    over ``model``."""
    fsdp = ("pod", "data")
    return {
        "in_x": pspec(fsdp, "model"),
        "in_gate": pspec(fsdp, "model"),
        "conv_w": pspec(None, "model"),
        "conv_b": pspec("model"),
        "w_a": pspec(None, "model"),
        "b_a": pspec("model"),
        "w_i": pspec(None, "model"),
        "b_i": pspec("model"),
        "lambda": pspec("model"),
        "out_proj": pspec("model", fsdp),
    }


class RGLRU(nn.Module):
    """Params and init as the reference's ``rglru_init``: ``lambda`` such
    that a^c is uniform in [0.9, 0.999]; ``b_a``, ``b_i`` and ``lambda`` stay
    fp32."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, w, k = cfg.d_model, cfg.rnn_width, cfg.ssm_conv
        self.cfg = cfg
        self.in_x = param(dense_init(d, w, dtype, device, generator))
        self.in_gate = param(dense_init(d, w, dtype, device, generator))
        conv = torch.randn(k, w, device=device, generator=generator)
        self.conv_w = param((conv / math.sqrt(k)).to(dtype))
        self.conv_b = param(torch.zeros(w, dtype=dtype, device=device))
        self.w_a = param(dense_init(w, w, dtype, device, generator))
        self.b_a = param(torch.zeros(w, device=device))
        self.w_i = param(dense_init(w, w, dtype, device, generator))
        self.b_i = param(torch.zeros(w, device=device))
        u = torch.rand(w, device=device, generator=generator) * 0.099 + 0.9
        # the reference's leaf name, a Python keyword: no attribute syntax
        self.register_parameter(
            "lambda", param(torch.log(torch.expm1(-torch.log(u) / C))))
        self.out_proj = param(dense_init(w, d, dtype, device, generator))

    def forward(self, x: torch.Tensor, pos: int = 0,
                cache: Optional[Dict[str, torch.Tensor]] = None):
        """x (B, S, d) -> (B, S, d).  A multi-token call starts at position
        0 from a zero state; a one-token call continues from ``cache`` (this
        layer's ``h``/``conv``).  Writes the new state into ``cache``."""
        S = x.shape[1]
        if S > 1 and pos:
            raise ValueError("a multi-token call starts at position 0")
        state = hist = None
        if cache is not None and S == 1:
            state, hist = cache["h"], cache["conv"]
        xb = shard(x @ gathered(self.in_x), BATCH, SEQ, HEADS)
        gate = act_fn("gelu")(x @ gathered(self.in_gate))
        xc = channelwise(causal_conv, xb, [
            (xb, True, -1), (self.conv_w, False, -1),
            (self.conv_b, False, -1), (hist, True, -1)], [(3, -1)])
        # h in x's dtype; h_last, the fp32 state after the last step
        h, h_last = channelwise(rglru_gated, xc, [
            (xc @ gathered(self.w_a), True, -1),
            (xc @ gathered(self.w_i), True, -1),
            (xc, True, -1), (self.b_a, False, -1), (self.b_i, False, -1),
            (self.get_parameter("lambda"), False, -1), (state, True, -1)],
            [(3, -1), (2, -1)])
        if cache is not None:
            cache["h"] = h_last
            K = self.cfg.ssm_conv
            cache["conv"] = channelwise(
                lambda xb, hist: conv_history(xb, hist, K), xb,
                [(xb, True, -1), (hist, True, -1)], [(3, -1)]).to(
                    cache["conv"].dtype)
        return (h * gate) @ gathered(self.out_proj)
