"""qwen2-7b [dense] — 28L, d_model 3584, 28H GQA kv=4, d_ff 18944,
vocab 152064, QKV bias, SwiGLU, RMSNorm [arXiv:2407.10671]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18_944,
    vocab=152_064, qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=128)
