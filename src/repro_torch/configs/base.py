"""Model/shape configuration schema: the port's own copy of
``repro/configs/base.py``, every field with the reference's default, the
parameter counts and the (arch x shape) cells' ``ShapeConfig``/``SHAPES``.

All ten configs are data here: the ``tpu`` cost model reads every one of
them, and the model runs every one (it raises ``NotImplementedError`` only
on fields none of them sets: the logit softcap, other MLPs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


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
    rope_fraction: float = 1.0      # partial rotary (stablelm 0.25, chatglm 0.5)
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

    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0       # llama4 shared expert
    capacity_factor: float = 1.25
    moe_every: int = 1              # MoE on every Nth layer (llama4: 2)
    moe_impl: str = "a2a"           # a2a (sorted local dispatch) | global

    # --- encoder-decoder (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0                # e.g. 1500 mel frames after conv stub

    # --- vlm ---
    img_tokens: int = 0             # image tokens prepended (frontend stub)

    # --- numerics / training ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"   # AdamW moments (bf16 for the giants)
    grad_accum_dtype: str = "float32"  # microbatch grad accumulator
    tie_embeddings: bool = False
    remat: str = "none"             # none | full | selective
    scan_layers: bool = True        # False: unroll (exact cost_analysis)
    exact_costs: bool = False       # unroll inner scans too (cost points)

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

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for kind in self.layer_kinds():
            if kind.startswith("attn"):
                per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
            elif kind == "mamba":
                di, ds = self.d_inner, self.ssm_state
                per_layer += d * 2 * di + di * self.ssm_conv \
                    + di * (self.dt_rank + 2 * ds) + self.dt_rank * di \
                    + di * ds + di + di * d
            elif kind == "rglru":
                w = self.rnn_width
                per_layer += 2 * d * w + w * self.ssm_conv + 2 * w + w * d
        # mlp per layer (mamba family has no separate mlp)
        n_mlp = 0 if self.family == "ssm" else self.n_layers
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        dense_mlp = mult * d * f
        if self.n_experts:
            moe_mlp = self.n_experts * mult * d * f + d * self.n_experts
            if self.n_shared_experts:
                moe_mlp += self.n_shared_experts * mult * d * f
            n_moe = n_mlp // self.moe_every
            mlp_total = n_moe * moe_mlp + (n_mlp - n_moe) * dense_mlp
        else:
            mlp_total = n_mlp * dense_mlp
        total = emb + per_layer + mlp_total
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder already counted
            total += self.n_enc_layers * (4 * d * d + mult * d * f)
            total += self.n_layers * 4 * d * d          # cross-attention
        return total

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not self.n_experts:
            return self.n_params
        d, f = self.d_model, self.d_ff
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        n_moe = self.n_layers // self.moe_every
        inactive = (self.n_experts - self.top_k) * mult * d * f * n_moe
        return self.n_params - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
