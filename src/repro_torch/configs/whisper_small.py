"""whisper-small [audio] — enc-dec, 12+12L, d_model 768, 12H MHA, d_ff 3072,
vocab 51865; conv frontend is a STUB: ``input_specs`` supplies 1500
precomputed frame embeddings [arXiv:2212.04356].

Departure from the published model (noted in DESIGN.md): decode shapes ask
for 32k-token decoder contexts; Whisper's real decoder is capped at 448
learned positions — we size the learned table to the requested shape.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51_865, is_encdec=True, n_enc_layers=12, enc_seq=1500,
    mlp="gelu", norm="layernorm",
)


def reduced() -> ModelConfig:
    """The same family at test size (the reference's ``reduced()``)."""
    return replace(CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=4, d_ff=128, vocab=128, enc_seq=12)
