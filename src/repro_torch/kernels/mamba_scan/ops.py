"""Mamba-1 selective scan: wrapper of ``csrc/mamba_scan.cu``.

Replaces ``repro/kernels/mamba_scan/ops.py:mamba_scan`` and its Pallas
kernel ``mamba_scan_kernel`` (inputs already discretised); any S and Di, no
padding, N in {4, 8, 16}.  Also returns the final state, which the Pallas
kernel drops.  A CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the kernel, and every launch adds one to
``mamba_scan.launches``.  The kernel has no backward yet: a CUDA call under
grad mode whose inputs require grad raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dtypes import code
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

STATE_SIZES = (4, 8, 16)
_i = ctypes.c_int


@functools.cache
def _fn():
    """The C entry point, its library built and loaded at first use."""
    f = _build.library("mamba_scan").mamba_scan_fwd
    f.argtypes = [ctypes.c_void_p] * 5 + [_i] * 5 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def mamba_scan(da: torch.Tensor, dbx: torch.Tensor,
               c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """da, dbx: (B, S, Di, N); c: (B, S, N) -> (y (B, S, Di) in da's dtype,
    h_last (B, Di, N) fp32), where ``h[t] = da[t] * h[t-1] + dbx[t]`` from
    ``h[-1] = 0`` and ``y[t, d] = sum_n h[t, d, n] * c[t, n]``."""
    if da.device.type == "cpu":
        return mamba_scan_ref(da, dbx, c)
    if da.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {da.device}")
    refuse_grad("mamba_scan", da, dbx, c)
    if da.dim() != 4 or dbx.shape != da.shape:
        raise ValueError(f"mamba_scan: da {tuple(da.shape)} and dbx "
                         f"{tuple(dbx.shape)} must both be (B, S, Di, N)")
    B, S, Di, N = da.shape
    if c.shape != (B, S, N):
        raise ValueError(f"mamba_scan: c {tuple(c.shape)} != {(B, S, N)}")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan: N={N} must be one of {STATE_SIZES}")
    if dbx.dtype != da.dtype or c.dtype != da.dtype:
        raise TypeError("mamba_scan: da, dbx and c must share a dtype")
    if any(t.device != da.device or not t.is_contiguous()
           for t in (da, dbx, c)):
        raise ValueError("mamba_scan: da, dbx, c must be contiguous and on "
                         "one device")
    if da.data_ptr() % 16 or dbx.data_ptr() % 16:
        raise ValueError("mamba_scan: da and dbx must be 16-byte aligned")
    y = torch.empty(B, S, Di, dtype=da.dtype, device=da.device)
    h_last = torch.empty(B, Di, N, dtype=torch.float32, device=da.device)
    err = _fn()(da.data_ptr(), dbx.data_ptr(), c.data_ptr(), y.data_ptr(),
                h_last.data_ptr(), code(da, "mamba_scan da"), B, S, Di, N,
                torch.cuda.current_stream(da.device).cuda_stream)
    _build.check(err, "mamba_scan_fwd")
    mamba_scan.launches += 1
    return y, h_last


mamba_scan.launches = 0
