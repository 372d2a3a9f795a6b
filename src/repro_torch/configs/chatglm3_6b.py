"""chatglm3-6b [dense] — 28L, d_model 4096, 32H GQA kv=2, d_ff 13696,
vocab 65024, 2d-RoPE (half dims), QKV bias [arXiv:2406.12793]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13_696,
    vocab=65_024, rope_fraction=0.5, qkv_bias=True, mlp="swiglu",
    norm="rmsnorm",
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=128)
