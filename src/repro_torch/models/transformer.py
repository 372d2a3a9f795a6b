"""Dense decoder LM: forward, KV cache, prefill and greedy-decode steps.

Counterpart: ``repro/models/transformer.py`` (``_attn_apply``,
``_mlp_apply``, ``_layer_apply``, ``_unembed``, ``forward``, ``init_cache``,
``prefill``, ``decode_step``).  The reference stacks each segment's layers
on a leading axis and scans them; here every layer is its own module and a
Python loop runs them (``repro_torch.convert`` unstacks reference params).

Numerics follow the reference: the residual stream, projections and MLP run
in the param dtype; RMSNorm is fp32 inside and rounds to the dtype (through
the fused kernel, plain form: ``x + mix`` is rounded before it is
normalised, as the reference does); RoPE angles are fp32; the logits are
``x @ unembed`` in the dtype, then cast to fp32.  Attention keeps its
probabilities in fp32 (the flash kernel's numerics), where the reference's
dense path rounds them to the dtype before P.V; the two agree tightly in
fp32 only.

Only dense full-causal attention layers with a SwiGLU MLP and RMSNorm are
ported; other kinds raise ``NotImplementedError`` naming their slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.common import (act_fn, apply_rope, dense_init,
                                       dtype_of, embed_init, rmsnorm)

_LATER = "a later slice of the port (ROADMAP.md, queue A)"
_RG = "the recurrentgemma-2b slice"
_SLICE_OF_KIND = {
    "rglru": f"{_RG} (rglru_scan)",
    "attn_local": f"{_RG} (rolling window cache)",
    "mamba": "the falcon-mamba-7b slice (mamba_scan)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for anything this slice does not run."""
    for kind in sorted(set(cfg.layer_kinds()) - {"attn"}):
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind!r} is not ported yet; it comes "
            f"with {_SLICE_OF_KIND.get(kind, _LATER)}")
    unported = (
        ("n_experts (MoE)", cfg.n_experts, "the MoE slice"),
        ("tie_embeddings", cfg.tie_embeddings, _RG),
        (f"mlp={cfg.mlp!r}", cfg.mlp != "swiglu",
         _RG if cfg.mlp == "geglu" else _LATER),
        (f"norm={cfg.norm!r}", cfg.norm != "rmsnorm", _LATER),
        ("is_encdec", cfg.is_encdec, _LATER),
        ("img_tokens", cfg.img_tokens, _LATER),
        ("attn_logit_softcap", cfg.attn_logit_softcap, _LATER),
    )
    for what, present, where in unported:
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; it comes with {where}")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)   # serving only


@dataclass
class KVCache:
    """Per-layer K/V buffers (n_layers, B, max_len, Hkv, D) in the model's
    dtype.  Slot i holds position i; ``length`` slots are written."""
    k: torch.Tensor
    v: torch.Tensor
    length: int = 0


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.cfg = cfg
        self.wq = _param(dense_init(d, cfg.n_heads * hd, dtype, device, generator))
        self.wk = _param(dense_init(d, cfg.n_kv_heads * hd, dtype, device, generator))
        self.wv = _param(dense_init(d, cfg.n_kv_heads * hd, dtype, device, generator))
        self.wo = _param(dense_init(cfg.n_heads * hd, d, dtype, device, generator))
        if cfg.qkv_bias:
            for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                                ("bv", cfg.n_kv_heads)):
                setattr(self, name, _param(torch.zeros(
                    width * hd, dtype=dtype, device=device)))

    def _proj(self, x, w, bias_name):
        y = x @ w
        return y + getattr(self, bias_name) if self.cfg.qkv_bias else y

    def forward(self, x, q_offset: int = 0,
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x: (B, S, d).  With ``cache_kv`` (this layer's K/V buffers) the new
        K/V are written to slots ``q_offset .. q_offset+S-1`` in place.  A
        prompt (S > 1, from position 0) attends over its own K/V; a decode
        step (S == 1) over the first ``q_offset + 1`` cache slots."""
        cfg = self.cfg
        B, S, _ = x.shape
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = self._proj(x, self.wq, "bq").view(B, S, hq, hd)
        k = self._proj(x, self.wk, "bk").view(B, S, hkv, hd)
        v = self._proj(x, self.wv, "bv").view(B, S, hkv, hd)
        pos = torch.arange(q_offset, q_offset + S, device=x.device)
        q = apply_rope(q, pos, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        k = apply_rope(k, pos, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        if cache_kv is None or S > 1:
            if q_offset:
                raise ValueError("a multi-token call starts at position 0")
            out = attention(q, k, v, q_offset=0)
        if cache_kv is not None:
            ck, cv = cache_kv
            if q_offset + S > ck.shape[1]:
                raise ValueError(f"cache of {ck.shape[1]} slots is full at "
                                 f"position {q_offset + S - 1}")
            ck[:, q_offset:q_offset + S] = k
            cv[:, q_offset:q_offset + S] = v
            if S == 1:
                out = attention(q, ck, cv, q_offset=q_offset,
                                kv_len=q_offset + 1)
        return out.reshape(B, S, hq * hd) @ self.wo


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param(dense_init(d, f, dtype, device, generator))
        self.w_up = _param(dense_init(d, f, dtype, device, generator))
        self.w_down = _param(dense_init(f, d, dtype, device, generator))

    def forward(self, x):
        return (act_fn("silu")(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


class Layer(nn.Module):
    """Pre-norm residual layer: attention, then SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg, dtype, device, generator)

    def forward(self, x, q_offset: int = 0, cache_kv=None):
        x = x + self.attn(self.norm1(x), q_offset, cache_kv)
        return x + self.mlp(self.norm2(x))


class Transformer(nn.Module):
    """Dense decoder LM with random weights drawn in the reference's scheme
    (normal/sqrt(d_in) projections, 0.02 embeddings, zero biases, unit norm
    scales) from ``generator``, or from a generator seeded with ``seed``.
    Load reference weights with ``load_state_dict(params_from_jax(...))``."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        dtype = dtype_of(cfg.param_dtype)
        self.cfg, self.dtype = cfg, dtype
        self.embed = _param(embed_init(cfg.vocab, cfg.d_model, dtype, device,
                                       generator))
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.unembed = _param(dense_init(cfg.d_model, cfg.vocab, dtype, device,
                                         generator))
        self.layers = nn.ModuleList(Layer(cfg, dtype, device, generator)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _unembed(self, x):
        x = self.final_norm(x)
        return (x @ self.unembed.to(x.dtype)).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, vocab) fp32, no cache."""
        x = F.embedding(tokens, self.embed)
        for layer in self.layers:
            x = layer(x)
        return self._unembed(x)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return KVCache(torch.zeros(shape, dtype=self.dtype, device=self.device),
                       torch.zeros(shape, dtype=self.dtype, device=self.device))

    def prefill(self, tokens: torch.Tensor,
                max_len: int) -> Tuple[torch.Tensor, KVCache]:
        """Run the prompt (B, S) from position 0, filling a fresh cache of
        ``max_len`` slots.  Returns (last-position logits (B, 1, V), cache)."""
        B, S = tokens.shape
        cache = self.init_cache(B, max_len)
        x = F.embedding(tokens, self.embed)
        for i, layer in enumerate(self.layers):
            x = layer(x, 0, (cache.k[i], cache.v[i]))
        cache.length = S
        return self._unembed(x[:, -1:].contiguous()), cache

    def decode_step(self, token: torch.Tensor, pos: int,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """One token (B, 1) at position ``pos`` for the whole batch.  Updates
        ``cache`` in place (the reference returns a new one) and returns
        (logits (B, 1, V), cache)."""
        pos = int(pos)
        if pos != cache.length:
            raise ValueError(f"decode at position {pos} but the cache holds "
                             f"{cache.length} positions")
        x = F.embedding(token, self.embed)
        for i, layer in enumerate(self.layers):
            x = layer(x, pos, (cache.k[i], cache.v[i]))
        cache.length = pos + 1
        return self._unembed(x), cache
