"""Prefill and decode step builders (counterpart: ``repro/launch/steps.py``
``make_prefill_step`` / ``make_decode_step``).

Steps take the reference's batch dicts.  There is no ``jit``: PyTorch runs
eagerly, and the kernels launch on the current CUDA stream.
"""
from __future__ import annotations

from repro_torch.models.transformer import Transformer


def make_prefill_step(model: Transformer, max_len: int):
    """``prefill_step(batch) -> (last logits (B, 1, V), cache)``; batch keys:
    ``tokens`` (B, S), and ``img_embeds`` (B, N, d) for an ``img_tokens``
    config (``max_len`` counts its N positions) or ``frames`` (B, T, d) for
    an ``is_encdec`` one."""
    def prefill_step(batch):
        return model.prefill(batch["tokens"], max_len=max_len,
                             img_embeds=batch.get("img_embeds"),
                             frames=batch.get("frames"))
    return prefill_step


def make_decode_step(model: Transformer):
    """``decode_step(batch) -> (logits (B, 1, V), cache)``; batch keys:
    ``token`` (B, 1), ``pos`` (int), ``caches`` (the prefill's cache; an
    ``is_encdec`` model's holds the cross K/V, so no ``enc_out``)."""
    def decode_step(batch):
        return model.decode_step(batch["token"], batch["pos"], batch["caches"])
    return decode_step
