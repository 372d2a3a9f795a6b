"""Refusing autograd where a kernel has no backward."""
from __future__ import annotations

import torch

SCAN_BACKWARD = ("the interface entry rglru_scan (a, b -> h) is on no model "
                 "path and has no backward kernel; the model's RG-LRU calls "
                 "rglru_gated, which has one")


class KernelRefusal(NotImplementedError):
    """A call that the card's kernels do not take (a dry run reports the
    step that makes it as refused)."""


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``KernelRefusal`` for a CUDA launch under grad mode with
    an input that requires grad: the kernel has no backward, and its output
    would silently carry no gradient back."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise KernelRefusal(
            f"{what}: no backward kernel on CUDA ({SCAN_BACKWARD}); the "
            f"inputs require grad and would be detached")
