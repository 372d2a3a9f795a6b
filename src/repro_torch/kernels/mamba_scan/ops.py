"""Mamba-1 selective scan: wrapper of ``csrc/mamba_scan.cu``.

Replaces ``repro/kernels/mamba_scan/ops.py:mamba_scan`` and its Pallas
kernel ``mamba_scan_kernel`` (inputs already discretised); any S and Di, no
padding, N in {4, 8, 16}.  Also returns the final state, which the Pallas
kernel drops.  A CPU tensor takes the plain version (``ref.py``), which
autograd differentiates; a CUDA tensor launches the kernel, and every
launch adds one to ``mamba_scan.launches``.  Training: a CUDA call under
grad mode whose inputs require grad goes through ``MambaScanFn``, whose
backward is :func:`mamba_scan_bwd` (its own kernel, counted in
``mamba_scan_bwd.launches``; it recomputes the states a chunk at a time
and saves none).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _fake
from repro_torch.kernels._dtypes import code
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_bwd_ref,
                                                mamba_scan_ref)

STATE_SIZES = (4, 8, 16)
BWD_STEPS = 16            # the backward's chunk of steps (kMbL)
BWD_BLOCK = 512           # the backward's elements (d, n) a block (kMbBlock)
_i = ctypes.c_int
_vp = ctypes.c_void_p


@functools.cache
def _fns():
    """The C entry points, their library built and loaded at first use."""
    lib = _build.library("mamba_scan")
    lib.mamba_scan_fwd.argtypes = [_vp] * 5 + [_i] * 5 + [_vp]
    lib.mamba_scan_bwd.argtypes = [_vp] * 11 + [_i] * 7 + [_vp] * 2
    for f in (lib.mamba_scan_fwd, lib.mamba_scan_bwd):
        f.restype = ctypes.c_int
    return lib


def _check(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor) -> None:
    """What the kernels take: CUDA, (B, S, Di, N) da and dbx, (B, S, N) c,
    one dtype, contiguous, N in STATE_SIZES."""
    if da.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {da.device}")
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


def mamba_scan(da: torch.Tensor, dbx: torch.Tensor,
               c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """da, dbx: (B, S, Di, N); c: (B, S, N) -> (y (B, S, Di) in da's dtype,
    h_last (B, Di, N) fp32), where ``h[t] = da[t] * h[t-1] + dbx[t]`` from
    ``h[-1] = 0`` and ``y[t, d] = sum_n h[t, d, n] * c[t, n]``.  Under grad
    mode with an input requiring grad, a CUDA call goes through
    ``MambaScanFn`` (backward: :func:`mamba_scan_bwd`)."""
    fake = _fake.is_fake(da)
    if da.device.type == "cpu" and not fake:
        return mamba_scan_ref(da, dbx, c)
    if not fake:
        _check(da, dbx, c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (da, dbx, c)):
        return MambaScanFn.apply(da, dbx, c)
    return _forward(da, dbx, c)


def _forward(da, dbx, c):
    """The forward kernel's launch on checked CUDA tensors."""
    B, S, Di, N = da.shape
    if _fake.is_fake(da):
        _fake.mamba_scan(da, c)
        return (torch.empty(B, S, Di, dtype=da.dtype, device=da.device),
                torch.empty(B, Di, N, dtype=torch.float32, device=da.device))
    if da.data_ptr() % 16 or dbx.data_ptr() % 16:
        raise ValueError("mamba_scan: da and dbx must be 16-byte aligned")
    y = torch.empty(B, S, Di, dtype=da.dtype, device=da.device)
    h_last = torch.empty(B, Di, N, dtype=torch.float32, device=da.device)
    err = _fns().mamba_scan_fwd(
        da.data_ptr(), dbx.data_ptr(), c.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), code(da, "mamba_scan da"), B, S, Di, N,
        torch.cuda.current_stream(da.device).cuda_stream)
    _build.check(err, "mamba_scan_fwd")
    mamba_scan.launches += 1
    return y, h_last


mamba_scan.launches = 0


class MambaScanFn(torch.autograd.Function):
    """The selective scan on the card under autograd: the forward kernel,
    then the backward kernel from the saved da, dbx and c."""

    @staticmethod
    def forward(ctx, da, dbx, c):
        ctx.save_for_backward(da, dbx, c)
        return _forward(da, dbx, c)

    @staticmethod
    def backward(ctx, dy, dh_last):
        da, dbx, c = ctx.saved_tensors
        dda, ddbx, dc = mamba_scan_bwd(da, dbx, c, dy.contiguous(),
                                       dh_last.contiguous())
        return dda.to(da.dtype), ddbx.to(dbx.dtype), dc.to(c.dtype)


def mamba_scan_bwd(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                   dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None,
                   marks=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`mamba_scan` for dy (B, S, Di) in da's dtype
    and dh_last (B, Di, N) fp32 (None: zero): (dda, ddbx (B, S, Di, N), dc
    (B, S, N)), all fp32.  A CPU tensor takes ``mamba_scan_bwd_ref``; a CUDA
    tensor launches the backward kernel (the states recomputed a chunk of
    BWD_STEPS steps at a time, the chunks chained in step order, dc summed
    over element blocks in fixed order), adding one to
    ``mamba_scan_bwd.launches``.  ``marks``: four ``torch.cuda.Event`` (see
    ``_build.event_marks``) recorded before the fold launch (and its
    scratch's memset) and after each launch, so that chip_smoke.py times
    the fold, grads and dc launches apart."""
    if _fake.is_fake(da):
        _fake.mamba_scan_bwd(da)
        f32 = lambda t: torch.empty_like(t, dtype=torch.float32)
        return f32(da), f32(dbx), f32(c)
    if da.device.type == "cpu":
        return mamba_scan_bwd_ref(da, dbx, c, dy, dh_last)
    _check(da, dbx, c)
    B, S, Di, N = da.shape
    if dy.shape != (B, S, Di) or dy.dtype != da.dtype or \
            dy.device != da.device or not dy.is_contiguous():
        raise ValueError(f"mamba_scan_bwd: dy must be a contiguous "
                         f"{(B, S, Di)} {da.dtype} tensor on {da.device}")
    if dh_last is not None and (
            dh_last.shape != (B, Di, N) or dh_last.dtype != torch.float32
            or dh_last.device != da.device or not dh_last.is_contiguous()):
        raise ValueError(f"mamba_scan_bwd: dh_last must be a contiguous "
                         f"{(B, Di, N)} fp32 tensor on {da.device}")
    if any(t is not None and t.data_ptr() % 16 for t in (da, dbx, dh_last)):
        raise ValueError("mamba_scan_bwd: da, dbx and dh_last must be "
                         "16-byte aligned")
    K = -(-S // BWD_STEPS)
    blocks = -(-(Di * N) // BWD_BLOCK)
    dev = da.device
    dda = torch.empty(B, S, Di, N, dtype=torch.float32, device=dev)
    ddbx = torch.empty_like(dda)
    dc = torch.empty(B, S, N, dtype=torch.float32, device=dev)
    carry = torch.empty(2, B, K, Di * N, dtype=torch.float32, device=dev)
    part = torch.empty(blocks, B, S, N, dtype=torch.float32, device=dev)
    sync = torch.empty(2 + 2 * K * B * blocks, dtype=torch.int32, device=dev)
    err = _fns().mamba_scan_bwd(
        da.data_ptr(), dbx.data_ptr(), c.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dda.data_ptr(),
        ddbx.data_ptr(), dc.data_ptr(), carry.data_ptr(), part.data_ptr(),
        sync.data_ptr(), code(da, "mamba_scan_bwd da"), B, S, Di, N,
        BWD_STEPS, BWD_BLOCK, torch.cuda.current_stream(dev).cuda_stream,
        _build.event_marks(marks, 4))
    _build.check(err, "mamba_scan_bwd")
    mamba_scan_bwd.launches += 1
    return dda, ddbx, dc


mamba_scan_bwd.launches = 0
