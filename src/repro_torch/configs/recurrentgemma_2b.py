"""recurrentgemma-2b [hybrid] — 26L, d_model 2560, 10H MQA (kv=1,
head_dim 256), d_ff 7680 GeGLU, vocab 256000; RG-LRU : local-attn pattern
2:1, window 2048 [arXiv:2402.19427]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256_000, lru_width=2560, attn_window=2048,
    block_pattern=("rglru", "rglru", "attn_local"),
    mlp="geglu", norm="rmsnorm", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
                   head_dim=16, d_ff=128, vocab=128, lru_width=64,
                   attn_window=8)
