"""dtype codes shared with ``csrc/common.cuh``."""
import torch

CODES = {torch.float32: 0, torch.bfloat16: 1}


def code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in CODES:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported "
                        f"(float32 or bfloat16)")
    return CODES[t.dtype]
