"""Shared model building blocks: dtypes, params, RMSNorm, LayerNorm, RoPE,
init, activations.

Counterpart: ``repro/models/common.py``.  Mesh and sharding helpers are not
ported (one card).  ``rmsnorm`` goes through the fused kernel's wrapper, so a
CUDA tensor runs ``csrc/rmsnorm.cu`` and a CPU tensor its plain version.
``layernorm`` is eager PyTorch on both: the reference computes it outside
any Pallas kernel, as it does the projections.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A parameter, frozen: serving builds no autograd graph.  Training
    unfreezes a whole model (``Transformer(..., trainable=True)``)."""
    return torch.nn.Parameter(t, requires_grad=False)


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * w`` in fp32, cast to x's dtype."""
    return fused_rmsnorm(x, w, eps=eps)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last axis,
    in fp32 (scale and bias too), cast to x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


# ---- initializers (the reference's scheme, drawn from a torch.Generator) ----

def dense_init(d_in: int, d_out: int, dtype, device,
               generator) -> torch.Tensor:
    """(d_in, d_out) weight, normal with std 1/sqrt(d_in), in ``x @ w``
    layout as the reference keeps it."""
    w = torch.randn(d_in, d_out, device=device, generator=generator)
    return (w / math.sqrt(d_in)).to(dtype)


def embed_init(vocab: int, d: int, dtype, device, generator) -> torch.Tensor:
    w = torch.randn(vocab, d, device=device, generator=generator)
    return (w * 0.02).to(dtype)


# ---- rotary position embeddings ----

def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> Tuple[torch.Tensor, int]:
    """Inverse frequencies of a (possibly partial) rotary embedding, and the
    number of rotated dims."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, theta: float = 10_000.0):
    """x: (..., S, H, head_dim); positions: (S,) or broadcastable to (..., S).

    Rotates the first ``rot`` dims by the half-split rule (not interleaved),
    with the angles in fp32, and casts the rotated part back to x's dtype.
    """
    inv, rot = rope_freqs(x.shape[-1], fraction, theta, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv        # (..., S, rot/2)
    sin = torch.sin(ang)[..., :, None, :]               # (..., S, 1, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2, xp = x[..., :rot // 2], x[..., rot // 2:rot], x[..., rot:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---- activations ----

def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]
