"""Optimizer, LR schedule and gradient compression (counterpart:
``repro.optim``), on dicts of tensors keyed like a model's ``state_dict``."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.optim.grad_compress import (compress_decompress_ef,
                                             ef_state_init)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_decompress_ef", "ef_state_init"]
