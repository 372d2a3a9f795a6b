"""dbrx-132b [moe] — 40L, d_model 6144, 48H GQA kv=8, d_ff 10752,
vocab 100352, MoE 16 experts top-4 (fine-grained)
[hf:databricks/dbrx-base]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10_752,
    vocab=100_352, n_experts=16, top_k=4, capacity_factor=1.25,
    mlp="swiglu", norm="layernorm", rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=128, n_experts=4, top_k=2,
                   capacity_factor=2.0)
