"""phi-3-vision-4.2b [vlm] — 32L, d_model 3072, 32H (kv=32), d_ff 8192,
vocab 32064; CLIP frontend is a STUB: each prompt is prefixed by 1024
precomputed image-patch embeddings
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32_064, img_tokens=1024, mlp="swiglu", norm="rmsnorm",
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab=128, img_tokens=8)
