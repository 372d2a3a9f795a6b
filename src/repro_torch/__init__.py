"""PyTorch/CUDA port of the LM substrate of ``repro``, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it (nor JAX).  Each Pallas TPU kernel on a ported path is a hand-written
CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use and bound
with ``ctypes`` (``kernels/_build.py``).  Entry points run on CUDA unless the
caller passes ``device="cpu"``; on CPU tensors each kernel wrapper takes its
plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
