"""stablelm-1.6b [dense] — 24L, d_model 2048, 32H (kv=32, MHA), d_ff 5632,
vocab 100352, partial RoPE (25%), LayerNorm
[hf:stabilityai/stablelm-2-1_6b]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100_352, rope_fraction=0.25, mlp="swiglu", norm="layernorm",
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab=128)
