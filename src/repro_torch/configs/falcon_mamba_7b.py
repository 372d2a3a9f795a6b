"""falcon-mamba-7b [ssm] — 64L, d_model 4096, attn-free Mamba-1, vocab 65024,
ssm_state 16 [arXiv:2410.05355]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65_024, ssm_state=16, ssm_conv=4, ssm_expand=2,
    norm="rmsnorm", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, d_model=32, vocab=128, ssm_state=4)
