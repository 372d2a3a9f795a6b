"""Model configuration schema: the port's own copy of the fields a dense
decoder reads (counterpart: ``repro/configs/base.py``).

Fields of model families the port does not run yet (MoE, SSM, hybrid,
encoder-decoder, VLM) are kept so that a config names what it is; the model
raises ``NotImplementedError`` on them.
"""
from __future__ import annotations

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
    attn_chunk: int = 0             # >0: chunked local attention
    global_every: int = 0           # with attn_chunk: 1-in-N layers global
    attn_logit_softcap: float = 0.0

    # --- mlp / norm ---
    mlp: str = "swiglu"             # swiglu | geglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm

    # --- families not ported yet ---
    n_experts: int = 0
    block_pattern: Tuple[str, ...] = ()
    is_encdec: bool = False
    img_tokens: int = 0

    # --- numerics ---
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

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
