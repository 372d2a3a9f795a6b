"""RG-LRU linear recurrence: wrappers of ``csrc/rglru_scan.cu``.

- :func:`rglru_scan` replaces ``repro/kernels/rglru_scan/ops.py:rglru_scan``
  and its Pallas kernel ``rglru_scan_kernel``: ``a, b -> h``;
- :func:`rglru_gated` is the same recurrence with the gate arithmetic of
  the reference's ``rglru_mix`` (``repro/models/rglru.py:75-89``) done in
  the kernel: ``xa = xc @ w_a, xi = xc @ w_i, xc -> (h, h_last)``, from an
  optional initial state; the model's prefill and decode step.

Any S and W, no padding.  A CPU tensor takes the plain version
(``ref.py``), which autograd differentiates; a CUDA tensor launches a
kernel, and never the plain version.  Training: a CUDA call of
:func:`rglru_gated` under grad mode whose inputs require grad goes through
``RGLRUGatedFn``, whose backward is :func:`rglru_gated_bwd` (its own
kernel, counted in ``rglru_gated_bwd.launches``).  ``rglru_scan``, the
interface entry, is on no model path and has no backward: a CUDA call
under grad whose inputs require grad raises ``NotImplementedError``.
Each launch adds one to the wrapper's ``launches``; ``rglru_scan`` also
counts by variant in ``rglru_scan.variant_launches``:

- ``ring``: a block per strip of channels of one batch row walks time in
  tiles, fed by a ring of shared-memory stages of asynchronous copies (the
  gated entry's only design);
- ``simple``: a thread per (batch, channel), the port's first design.

:func:`plan` picks the variant and the launch shape.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dtypes import code
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.rglru_scan.ref import (rglru_gated_bwd_ref,
                                              rglru_gated_ref,
                                              rglru_scan_ref)

_i = ctypes.c_int
_vp = ctypes.c_void_p
VARIANTS = ("ring", "simple")
# the ring's tile by entry and dtype (placed by ``chip_smoke.py
# --scan-sweep`` at recurrentgemma-2b's prefill shape): channels a block,
# steps a thread, threads a channel (the split of a tile's steps), ring
# stages
TILES = {("interface", torch.bfloat16): (64, 16, 2, 3),
         ("interface", torch.float32): (64, 16, 2, 2),
         ("gated", torch.bfloat16): (32, 8, 4, 2),
         ("gated", torch.float32): (32, 8, 4, 2)}
CHANNELS = (32, 64)              # the kernel's instances
STEPS_PER_THREAD = (8, 16)
MAX_THREADS = 512
MAX_STAGES = 4
MAX_SMEM = 232448         # an H100 block's opt-in shared memory, bytes
COPY_BYTES = (16, 8, 4, 2)
SIMPLE_THREADS = 64
BWD_STEPS = 32            # the backward's chunk of steps (kBwdL)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The variant of a call and its launch shape: a grid of ``blocks``
    blocks of ``threads``; for ``ring`` a strip of ``channels``, tiles of
    ``steps`` split over ``split`` threads a channel, ``stages`` ring stages
    of copies of ``copy_bytes`` each (2: through registers) and
    ``smem_bytes`` of shared memory."""
    variant: str
    threads: int
    blocks: int
    channels: int = 0
    steps: int = 0
    split: int = 0
    stages: int = 0
    copy_bytes: int = 0
    smem_bytes: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def variants(gated: bool = False) -> tuple:
    """The variants that can take a call, the plan's first: both take any
    shape; the gated entry has only the ring."""
    return ("ring",) if gated else VARIANTS


@functools.lru_cache(maxsize=1024)
def plan(B: int, S: int, W: int, dtype: torch.dtype,
         variant: Optional[str] = None, *, gated: bool = False,
         align: int = 16, tile: Optional[Tuple[int, int, int, int]] = None
         ) -> Plan:
    """The variant and launch shape of a call on (B, S, W) tensors of
    ``dtype`` (pure Python, no device; cached); ``align``: the largest power
    of two up to 16 dividing every tensor's address, in bytes.

    ``ring``, unless ``variant`` forces ``simple`` (the gated entry has no
    other; forcing it there, or an unknown name, raises).  From the entry's
    TILES (C channels, L steps a thread, G threads a channel, P stages): a
    strip of C channels; G cut to the threads S needs, and at one thread L
    to the smallest of STEPS_PER_THREAD that holds S; a tile of G x L
    steps; P cut to one more than the tiles (at least 2); C x G threads;
    copies of the largest of COPY_BYTES that divides a row (W
    elements) and ``align`` and is at least one element.  ``tile`` =
    (channels, steps, stages, split) forces the tile (the sweep); a tile
    beyond the kernel's limits raises."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"rglru_scan: unknown variant {variant!r}, not one "
                         f"of {VARIANTS}")
    can = variants(gated)
    variant = variant or can[0]
    if variant not in can:
        raise ValueError(f"rglru_gated: the {variant} variant cannot take "
                         f"the gated entry")
    if variant == "simple":
        if tile is not None:
            raise ValueError("rglru_scan: the simple variant takes no tile")
        return Plan("simple", SIMPLE_THREADS,
                    B * _cdiv(W, SIMPLE_THREADS))
    es = dtype.itemsize
    if tile is None:
        C, L, G, P = TILES["gated" if gated else "interface", dtype]
        G = max(1, min(G, _cdiv(S, L)))
        if G == 1:
            L = next(n for n in STEPS_PER_THREAD if n >= min(S, L))
        T = G * L
        P = max(2, min(P, _cdiv(S, T) + 1))
    else:
        C, T, P, G = tile
    copy = next(v for v in COPY_BYTES
                if v == es or (v > es and (W * es) % v == 0
                               and align % v == 0))
    smem = P * (3 if gated else 2) * T * C * es + 8 * G * C
    if (C not in CHANNELS or G < 1 or T % G
            or T // G not in STEPS_PER_THREAD or C * G > MAX_THREADS
            or not 2 <= P <= MAX_STAGES or smem > MAX_SMEM):
        raise ValueError(f"rglru_scan: tile (channels {C}, steps {T}, stages "
                         f"{P}, split {G}) of {dtype} is beyond the kernel's "
                         f"limits ({smem} bytes of shared memory)")
    return Plan("ring", C * G, B * _cdiv(W, C), C, T, G, P, copy, smem)


@functools.cache
def _fns():
    """The C entry points, their library built and loaded at first use."""
    lib = _build.library("rglru_scan")
    lib.rglru_scan_fwd.argtypes = [_vp] * 3 + [_i] * 4 + [_vp]
    lib.rglru_scan_ring_fwd.argtypes = [_vp] * 3 + [_i] * 9 + [_vp]
    lib.rglru_gated_fwd.argtypes = [_vp] * 9 + [_i] * 9 + [_vp]
    lib.rglru_gated_bwd.argtypes = [_vp] * 18 + [_i] * 5 + [_vp]
    for f in (lib.rglru_scan_fwd, lib.rglru_scan_ring_fwd,
              lib.rglru_gated_fwd, lib.rglru_gated_bwd):
        f.restype = ctypes.c_int
    return lib


def _align(tensors) -> int:
    """The largest power of two up to 16 dividing every address."""
    a = 16
    for t in tensors:
        p = t.data_ptr()
        while p % a:
            a //= 2
    return a


def _check(what: str, first: torch.Tensor, same: dict, vectors: dict,
           state: Optional[torch.Tensor]) -> None:
    """Device, dtype, shape and layout checks of either wrapper, on every
    device (so that the plain CPU path refuses what the kernel would):
    ``same`` must match ``first`` (B, S, W) in shape and dtype, ``vectors``
    be (W,) fp32, ``state`` (B, W) fp32."""
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {first.device}")
    if first.dim() != 3:
        raise ValueError(f"{what}: {tuple(first.shape)} is not (B, S, W)")
    code(first, what)
    B, _, W = first.shape
    want = {**{n: (first.shape, first.dtype) for n in same},
            **{n: ((W,), torch.float32) for n in vectors}}
    tensors = {**same, **vectors}
    if state is not None:
        want["h0"] = ((B, W), torch.float32)
        tensors["h0"] = state
    for name, t in tensors.items():
        shape, dt = want[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, not {dt}")
    if any(t.device != first.device or not t.is_contiguous()
           for t in [first, *tensors.values()]):
        raise ValueError(f"{what}: the tensors must be contiguous and on one "
                         f"device")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *,
               variant: Optional[str] = None,
               tile: Optional[Tuple[int, int, int, int]] = None
               ) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W) in a's dtype:
    ``h[t] = a[t] * h[t-1] + b[t]`` from ``h[-1] = 0``, state in fp32.
    ``variant`` (``ring`` or ``simple``) and ``tile`` (channels, steps,
    stages, split) force the plan's choice; the models never pass them."""
    _check("rglru_scan", a, {"b": b}, {}, None)
    B, S, W = a.shape
    how = plan(B, S, W, a.dtype, variant, align=_align((a, b)), tile=tile)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    refuse_grad("rglru_scan", a, b)
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ptrs = (a.data_ptr(), b.data_ptr(), h.data_ptr())
    if how.variant == "ring":
        err = _fns().rglru_scan_ring_fwd(
            *ptrs, code(a, "rglru_scan a"), B, S, W, how.channels, how.steps,
            how.stages, how.split, how.copy_bytes, stream)
    else:
        err = _fns().rglru_scan_fwd(*ptrs, code(a, "rglru_scan a"), B, S, W,
                                    stream)
    _build.check(err, f"rglru_scan ({how.variant})")
    rglru_scan.launches += 1
    rglru_scan.variant_launches[how.variant] += 1
    return h


rglru_scan.launches = 0
rglru_scan.variant_launches = dict.fromkeys(VARIANTS, 0)


def rglru_gated(xa: torch.Tensor, xi: torch.Tensor, xc: torch.Tensor,
                b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *,
                tile: Optional[Tuple[int, int, int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xa = xc @ w_a, xi = xc @ w_i, xc: (B, S, W) in the model's dtype;
    b_a, b_i, lam (the ``lambda`` param): (W,) fp32; h0: (B, W) fp32 or
    None (zero) -> (h (B, S, W) in xc's dtype, h_last (B, W) fp32), where
    ``r = sigmoid(xa + b_a)``, ``i = sigmoid(xi + b_i)``,
    ``a = exp(8 r log_a_hat)`` with ``log_a_hat = -softplus(lam)``,
    ``b = sqrt(max(1 - a^2, 1e-12)) i xc`` and ``h[t] = a[t] h[t-1] + b[t]``;
    h_last is the last state before rounding.  ``tile`` forces the ring's
    (channels, steps, stages, split); the models never pass it.  Under
    grad mode with an input requiring grad, a CUDA call goes through
    ``RGLRUGatedFn`` (backward: :func:`rglru_gated_bwd`)."""
    _check("rglru_gated", xc, {"xa": xa, "xi": xi},
           {"b_a": b_a, "b_i": b_i, "lam": lam}, h0)
    B, S, W = xc.shape
    if S == 0:
        raise ValueError("rglru_gated: no steps")
    how = plan(B, S, W, xc.dtype, gated=True, align=_align((xa, xi, xc)),
               tile=tile)
    if xc.device.type == "cpu":
        return rglru_gated_ref(xa, xi, xc, b_a, b_i, lam, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xa, xi, xc, b_a, b_i, lam, h0)):
        return RGLRUGatedFn.apply(xa, xi, xc, b_a, b_i, lam, h0, how)
    return _gated_fwd(xa, xi, xc, b_a, b_i, lam, h0, how)


def _gated_fwd(xa, xi, xc, b_a, b_i, lam, h0, how: Plan):
    """The gated entry's launch on checked CUDA tensors."""
    B, S, W = xc.shape
    h = torch.empty_like(xc)
    h_last = torch.empty(B, W, dtype=torch.float32, device=xc.device)
    err = _fns().rglru_gated_fwd(
        xa.data_ptr(), xi.data_ptr(), xc.data_ptr(), b_a.data_ptr(),
        b_i.data_ptr(), lam.data_ptr(),
        None if h0 is None else h0.data_ptr(), h.data_ptr(),
        h_last.data_ptr(), code(xc, "rglru_gated xc"), B, S, W,
        how.channels, how.steps, how.stages, how.split, how.copy_bytes,
        torch.cuda.current_stream(xc.device).cuda_stream)
    _build.check(err, "rglru_gated_fwd")
    rglru_gated.launches += 1
    return h, h_last


rglru_gated.launches = 0


class RGLRUGatedFn(torch.autograd.Function):
    """The gated RG-LRU on the card under autograd: the forward kernel,
    then the backward kernel from the saved inputs (it recomputes a, b and
    h in fp32; the rounded h is not saved)."""

    @staticmethod
    def forward(ctx, xa, xi, xc, b_a, b_i, lam, h0, how):
        ctx.save_for_backward(xa, xi, xc, b_a, b_i, lam, h0)
        return _gated_fwd(xa, xi, xc, b_a, b_i, lam, h0, how)

    @staticmethod
    def backward(ctx, dh, dh_last):
        xa, xi, xc, b_a, b_i, lam, h0 = ctx.saved_tensors
        grads = rglru_gated_bwd(xa, xi, xc, b_a, b_i, lam, h0,
                                dh.contiguous(), dh_last.contiguous())
        return (*grads, None)


def rglru_gated_bwd(xa: torch.Tensor, xi: torch.Tensor, xc: torch.Tensor,
                    b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                    h0: Optional[torch.Tensor], dh: torch.Tensor,
                    dh_last: Optional[torch.Tensor] = None
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradients of :func:`rglru_gated` for dh (B, S, W) in xc's dtype
    and dh_last (B, W) fp32 (None: zero): (dxa, dxi, dxc in xc's dtype;
    db_a, db_i, dlam (W,) fp32; dh0 (B, W) fp32, None without h0).  A CPU
    tensor takes ``rglru_gated_bwd_ref``; a CUDA tensor launches the
    backward kernel (recomputing the forward's a, b and h in fp32 with its
    arithmetic, chunks of BWD_STEPS steps, the (W,) sums in fixed order),
    adding one to ``rglru_gated_bwd.launches``."""
    _check("rglru_gated_bwd", xc, {"xa": xa, "xi": xi, "dh": dh},
           {"b_a": b_a, "b_i": b_i, "lam": lam}, h0)
    if dh_last is not None:
        _check("rglru_gated_bwd", xc, {}, {}, dh_last)
    if xc.device.type == "cpu":
        return rglru_gated_bwd_ref(xa, xi, xc, b_a, b_i, lam, h0, dh,
                                   dh_last)
    B, S, W = xc.shape
    K = _cdiv(S, BWD_STEPS)
    dxa, dxi, dxc = (torch.empty_like(xc) for _ in range(3))
    db_a, db_i, dlam = (torch.empty(W, dtype=torch.float32, device=xc.device)
                        for _ in range(3))
    dh0 = None if h0 is None else torch.empty_like(h0)
    carry = torch.empty(3, B, K, W, dtype=torch.float32, device=xc.device)
    part = torch.empty(3, B, K, W, dtype=torch.float64, device=xc.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _fns().rglru_gated_bwd(
        *(ptr(t) for t in (xa, xi, xc, dh, b_a, b_i, lam, h0, dh_last, dxa,
                           dxi, dxc, db_a, db_i, dlam, dh0, carry, part)),
        code(xc, "rglru_gated_bwd xc"), B, S, W, BWD_STEPS,
        torch.cuda.current_stream(xc.device).cuda_stream)
    _build.check(err, "rglru_gated_bwd")
    rglru_gated_bwd.launches += 1
    return dxa, dxi, dxc, db_a, db_i, dlam, dh0


rglru_gated_bwd.launches = 0
