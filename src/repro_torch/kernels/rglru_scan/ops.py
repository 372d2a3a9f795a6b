"""RG-LRU linear recurrence: wrapper of ``csrc/rglru_scan.cu``.

Replaces ``repro/kernels/rglru_scan/ops.py:rglru_scan`` and its Pallas
kernel ``rglru_scan_kernel``; any S and W, no padding.  A CPU tensor takes
the plain version (``ref.py``); a CUDA tensor launches the kernel, and every
launch adds one to ``rglru_scan.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dtypes import code
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_i = ctypes.c_int


@functools.cache
def _fn():
    """The C entry point, its library built and loaded at first use."""
    f = _build.library("rglru_scan").rglru_scan_fwd
    f.argtypes = [ctypes.c_void_p] * 3 + [_i] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W) in a's dtype:
    ``h[t] = a[t] * h[t-1] + b[t]`` from ``h[-1] = 0``, state in fp32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be (B, S, W)")
    if b.dtype != a.dtype:
        raise TypeError("rglru_scan: a and b must share a dtype")
    if b.device != a.device or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous and on one "
                         "device")
    B, S, W = a.shape
    h = torch.empty_like(a)
    err = _fn()(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                code(a, "rglru_scan a"), B, S, W,
                torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "rglru_scan_fwd")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
