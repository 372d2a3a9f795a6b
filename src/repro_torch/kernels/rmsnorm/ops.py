"""Fused RMSNorm (plain and residual forms): wrapper of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm/ops.py:fused_rmsnorm`` and its Pallas
kernel ``rmsnorm_kernel``.  The leading dims are flattened into rows.  A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
variant that :func:`plan` names, and every launch adds one to
``fused_rmsnorm.launches``, to its variant's entry of
``fused_rmsnorm.variant_launches`` and, for the residual form, to
``fused_rmsnorm.residual_launches``:

- ``vector``: a group of threads per row moving 16-byte vectors, the row and
  its weights in registers, several rows a block in a grid-stride loop; for
  a d that 16-byte vectors divide and 16-byte aligned tensors;
- ``generic``: one block per row, scalar accesses, the row in shared
  memory; any d (the port's first design).

Training: on a CUDA tensor, a call under grad mode whose x or w requires
grad goes through ``RMSNormFn``, whose forward is the same launch and whose
backward is ``rmsnorm_bwd`` (``csrc/rmsnorm.cu``'s backward entry, counted
in ``rmsnorm_bwd.launches``); the residual form has no backward kernel and
raises there.  A CPU tensor's plain version is differentiated by autograd.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, _fake
from repro_torch.kernels._dtypes import code
from repro_torch.kernels._grad import KernelRefusal
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

_vp = ctypes.c_void_p
VARIANTS = ("vector", "generic")
VECTOR_BYTES = 16
BLOCK = 256             # threads a block of the vector variant
GROUPS = (32, 64, 128, 256)   # threads a row may take (the block's warps)
# 32-bit registers of row data a thread may hold: V vectors of 4 words each
# of this row and the next (x, and r in the residual form) and of w, so 20 V
# words in the residual form
REG_BUDGET = 128
VMAX = REG_BUDGET // 20  # vectors a thread holds (a template argument, 1-6)
VTARGET = 4             # preferred vectors a thread, among equal fits
BWD_BLOCKS = 264        # backward: blocks walking the rows (2 an H100 SM);
                        # each writes a partial dw row the second kernel sums
BWD_MAX_D = 8192        # backward: 256 threads x 32 columns of a row


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which variant runs a call and, for ``vector``, its launch shape:
    ``threads`` per row and ``vectors`` of 16 bytes a thread (thread t of a
    row holds the vectors t, t + threads, ... of the row; a 256-thread block
    takes 256 / threads rows)."""
    variant: str
    threads: int = 0
    vectors: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(variant: Optional[str]) -> None:
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"fused_rmsnorm: unknown variant {variant!r}, not "
                         f"one of {VARIANTS}")


def _vector_shape(d: int, dtype: torch.dtype, aligned: bool):
    """(threads, vectors) of the vector variant for rows of d
    values, or None where it cannot take them."""
    e = VECTOR_BYTES // dtype.itemsize
    nvec = d // e
    fits = [(g * _cdiv(nvec, g) - nvec, abs(_cdiv(nvec, g) - VTARGET), g)
            for g in GROUPS if _cdiv(nvec, g) <= VMAX]
    if not (aligned and d > 0 and d % e == 0 and fits):
        return None
    _, _, g = min(fits)
    return g, _cdiv(nvec, g)


def variants(d: int, dtype: torch.dtype, aligned: bool = True) -> tuple:
    """The variants that can take rows of d values of ``dtype``, the
    plan's first."""
    vector = _vector_shape(d, dtype, aligned) is not None
    return ("vector", "generic") if vector else ("generic",)


@functools.lru_cache(maxsize=1024)
def plan(d: int, dtype: torch.dtype, aligned: bool = True,
         variant: Optional[str] = None) -> Plan:
    """The variant for rows of ``d`` values of ``dtype`` (pure Python, no
    device; cached: a call per launch); ``aligned``: every pointer 16-byte
    aligned.

    ``vector`` when 16-byte vectors divide d, the pointers are aligned and
    a row fits 256 threads of at most VMAX vectors; its threads per row are
    the count of GROUPS that leaves the fewest idle vector slots (threads x
    vectors - vectors of the row), ties going to the count nearest VTARGET
    vectors a thread.  Else ``generic``.  The row count does not change the
    choice (the C entry point sizes the grid from it).  ``variant`` forces
    one, and raises if it cannot take the call."""
    _check(variant)
    can = variants(d, dtype, aligned)
    variant = variant or can[0]
    if variant not in can:
        raise ValueError(f"fused_rmsnorm: the {variant} variant cannot take "
                         f"d {d} of {dtype} (aligned: {aligned})")
    if variant == "generic":
        return Plan("generic")
    return Plan("vector", *_vector_shape(d, dtype, aligned))


@functools.cache
def _fns():
    """The C entry points, their library built and loaded at first use."""
    lib = _build.library("rmsnorm")
    head = [_vp, _vp, _vp, _vp, _vp, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, ctypes.c_int]
    lib.rmsnorm_fwd.argtypes = head + [_vp]
    lib.rmsnorm_vector_fwd.argtypes = head + [ctypes.c_int, ctypes.c_int, _vp]
    lib.rmsnorm_bwd.argtypes = [_vp] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int, _vp]
    for f in (lib.rmsnorm_fwd, lib.rmsnorm_vector_fwd, lib.rmsnorm_bwd):
        f.restype = ctypes.c_int
    return lib.rmsnorm_fwd, lib.rmsnorm_vector_fwd, lib.rmsnorm_bwd


class RMSNormFn(torch.autograd.Function):
    """The plain form on the card: the forward kernel, then the backward
    kernel from the saved x and w."""

    @staticmethod
    def forward(ctx, x, w, eps, variant):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _launch(x, w, None, eps, variant)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None, None


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor,
                  residual: torch.Tensor | None = None, *,
                  eps: float = 1e-6, variant: Optional[str] = None):
    """x: (..., D), w: (D,); residual: optional, like x, added in fp32 before
    the norm.  Returns y, or (y, x + residual) when a residual is given.
    ``variant`` forces a kernel (``vector`` or ``generic``) instead of the
    plan's choice; the models never pass it.  Under grad mode with x or w
    requiring grad, the plain form goes through ``RMSNormFn`` (the residual
    form raises)."""
    _check(variant)
    fake = _fake.is_fake(x)
    if x.device.type == "cpu" and not fake:
        return rmsnorm_ref(x, w, residual, eps=eps)
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"fused_rmsnorm: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, residual)):
        if residual is not None:
            raise KernelRefusal(
                "fused_rmsnorm: the residual form has no backward kernel (it "
                "is on no model path: ROADMAP.md B7)")
        return RMSNormFn.apply(x, w, eps, variant)
    return _launch(x, w, residual, eps, variant)


def _launch(x, w, residual, eps, variant):
    """The forward kernel's launch on CUDA tensors (checks included)."""
    if _fake.is_fake(x):
        _fake.rmsnorm(x)
        y = torch.empty_like(x)
        return y if residual is None else (y, torch.empty_like(x))
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
    ptrs = [t.data_ptr() for t in tensors + [y] + ([] if res is None
                                                    else [res])]
    n = x.numel() // D if D else 0
    how = plan(D, x.dtype, all(p % VECTOR_BYTES == 0 for p in ptrs), variant)
    args = (x.data_ptr(), None if residual is None else residual.data_ptr(),
            w.data_ptr(), y.data_ptr(),
            None if res is None else res.data_ptr(), n, D, eps, dt)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    generic, vector, _ = _fns()
    if how.variant == "vector":
        err = vector(*args, how.threads, how.vectors, stream)
        _build.check(err, "rmsnorm_vector_fwd")
    else:
        err = generic(*args, stream)
        _build.check(err, "rmsnorm_fwd")
    fused_rmsnorm.launches += 1
    fused_rmsnorm.variant_launches[how.variant] += 1
    if res is None:
        return y
    fused_rmsnorm.residual_launches += 1
    return y, res


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6):
    """The plain form's backward: x, dy (..., D), w (D,) -> (dx like x, dw
    like w).  A CPU tensor takes ``rmsnorm_bwd_ref``; a CUDA tensor launches
    ``rmsnorm_bwd`` (two kernels: dx with per-block fp64 partial dw rows,
    then their sum in block order), adding one to
    ``rmsnorm_bwd.launches``."""
    if _fake.is_fake(x):
        _fake.rmsnorm_bwd(x)
        return torch.empty_like(x), torch.empty_like(w)
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    D = x.shape[-1]
    if w.shape != (D,) or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: w {tuple(w.shape)}, dy "
                         f"{tuple(dy.shape)} do not match x {tuple(x.shape)}")
    if not 0 < D <= BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: d {D} must be in 1..{BWD_MAX_D}")
    dt = code(x, "rmsnorm_bwd x")
    if w.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError("rmsnorm_bwd: w and dy must have x's dtype")
    if any(t.device != x.device or not t.is_contiguous() for t in (x, w, dy)):
        raise ValueError("rmsnorm_bwd: tensors must be contiguous and on one "
                         "device")
    n = x.numel() // D
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    blocks = min(n, BWD_BLOCKS)
    partial = torch.empty(blocks, D, dtype=torch.float64, device=x.device)
    err = _fns()[2](x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    dw.data_ptr(), partial.data_ptr(), n, D, eps, dt, blocks,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0
fused_rmsnorm.launches = 0            # every launch
fused_rmsnorm.residual_launches = 0   # the launches of the residual form
fused_rmsnorm.variant_launches = dict.fromkeys(VARIANTS, 0)
