"""starcoder2-3b [dense] — 30L, d_model 3072, 24H GQA kv=2, d_ff 12288,
vocab 49152, RoPE, GELU MLP, LayerNorm [arXiv:2402.19173]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12_288,
    vocab=49_152, mlp="gelu", norm="layernorm", qkv_bias=True,
    rope_theta=999_999.4,
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=128)
