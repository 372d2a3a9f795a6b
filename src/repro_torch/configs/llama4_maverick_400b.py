"""llama4-maverick-400b-a17b [moe] — 48L, d_model 5120, 40H GQA kv=8,
d_ff 8192, vocab 202048, MoE 128 experts top-1 + shared expert on every 2nd
layer (interleave_moe_layer_step=2, as in the published model — this is what
makes 128e x 48L land at ~400B total / ~17B active), iRoPE-style
chunked-local attention (8192) with 1-in-4 global layers
[hf:meta-llama/Llama-4-Scout-17B-16E family]."""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202_048, n_experts=128, top_k=1, n_shared_experts=1, moe_every=2,
    capacity_factor=1.25, attn_chunk=8192, global_every=4,
    mlp="swiglu", norm="rmsnorm", rope_theta=500_000.0,
    moment_dtype="bfloat16",     # 400B: fp32 moments would not fit the pod
    grad_accum_dtype="bfloat16",  # ditto for the microbatch accumulator
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=128, n_experts=4, top_k=1,
                   n_shared_experts=1, moe_every=2, attn_chunk=8,
                   global_every=4, capacity_factor=2.0)
