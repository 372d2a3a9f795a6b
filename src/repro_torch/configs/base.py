"""Model configuration schema: the port's own copy of the fields the ported
model families read (counterpart: ``repro/configs/base.py``): dense
decoders, the Mamba-1 SSM and the RG-LRU/local-attention hybrid.

Fields of families the port does not run yet (MoE, encoder-decoder, VLM) are
kept so that a config names what it is; the model raises
``NotImplementedError`` on them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- attention ---
    head_dim: int = 0               # 0 => d_model // n_heads
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # partial rotary (chatglm 0.5)
    qkv_bias: bool = False
    attn_window: int = 0            # >0: sliding-window attention
    attn_chunk: int = 0             # >0: chunked local attention
    global_every: int = 0           # with attn_chunk: 1-in-N layers global
    attn_logit_softcap: float = 0.0

    # --- mlp / norm ---
    mlp: str = "swiglu"             # swiglu | geglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm

    # --- ssm (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 => ceil(d_model / 16)

    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0              # 0 => d_model

    # --- families not ported yet ---
    n_experts: int = 0
    is_encdec: bool = False
    img_tokens: int = 0

    # --- numerics ---
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def rnn_width(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer token-mixer kind, length n_layers."""
        if self.family == "ssm":
            return ("mamba",) * self.n_layers
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.attn_chunk and self.global_every:
            return tuple("attn_global" if (i + 1) % self.global_every == 0
                         else "attn_chunk" for i in range(self.n_layers))
        return ("attn",) * self.n_layers
