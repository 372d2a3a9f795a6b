"""Fused RMSNorm (plain and residual forms): wrapper of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm/ops.py:fused_rmsnorm`` and its Pallas
kernel ``rmsnorm_kernel``.  The leading dims are flattened into rows.  A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel, and every launch adds one to ``fused_rmsnorm.launches`` (and a
launch of the residual form also to ``fused_rmsnorm.residual_launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dtypes import code
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_vp = ctypes.c_void_p


@functools.cache
def _fn():
    """The C entry point, its library built and loaded at first use."""
    lib = _build.library("rmsnorm")
    f = lib.rmsnorm_fwd
    f.argtypes = [_vp, _vp, _vp, _vp, _vp, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_float, ctypes.c_int, _vp]
    f.restype = ctypes.c_int
    return f


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor,
                  residual: torch.Tensor | None = None, *,
                  eps: float = 1e-6):
    """x: (..., D), w: (D,); residual: optional, like x, added in fp32 before
    the norm.  Returns y, or (y, x + residual) when a residual is given."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, residual, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: unsupported device {x.device}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"fused_rmsnorm: w {tuple(w.shape)} != ({D},)")
    dt = code(x, "fused_rmsnorm x")
    if w.dtype != x.dtype:
        raise TypeError("fused_rmsnorm: w must have x's dtype")
    tensors = [x, w] + ([] if residual is None else [residual])
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_rmsnorm: tensors must be contiguous and on "
                         "one device")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("fused_rmsnorm: residual must match x")
    y = torch.empty_like(x)
    res = None if residual is None else torch.empty_like(x)
    err = _fn()(x.data_ptr(), None if residual is None else residual.data_ptr(),
                w.data_ptr(), y.data_ptr(),
                None if res is None else res.data_ptr(),
                x.numel() // D, D, eps, dt,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm_fwd")
    fused_rmsnorm.launches += 1
    if res is None:
        return y
    fused_rmsnorm.residual_launches += 1
    return y, res


fused_rmsnorm.launches = 0            # every launch
fused_rmsnorm.residual_launches = 0   # the launches of the residual form
