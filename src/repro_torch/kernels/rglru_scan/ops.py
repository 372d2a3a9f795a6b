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
``RGLRUGatedFn``, whose forward also keeps the fp32 state entering every
BWD_STEPS-th step and whose backward is :func:`rglru_gated_bwd` (its own
kernel, counted in ``rglru_gated_bwd.launches``), from those states.
``rglru_scan``, the interface entry, is on no model path and has no
backward: a CUDA call under grad whose inputs require grad raises
``NotImplementedError``.
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

from repro_torch.kernels import _build, _fake
from repro_torch.kernels._dtypes import code
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.rglru_scan.ref import (rglru_gated_bwd_ref,
                                              rglru_gated_ref,
                                              rglru_scan_ref,
                                              rglru_states_ref)

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
BWD_STEPS = 64            # the backward kernel's chunk of steps


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
         align: int = 16, tile: Optional[Tuple[int, int, int, int]] = None,
         states: int = 0) -> Plan:
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
    beyond the kernel's limits raises.  ``states`` (the gated entry): keep
    the state entering every ``states``-th step, which must be a power of
    two and a multiple of the tile's steps a thread (the thread starting
    there stores it)."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"rglru_scan: unknown variant {variant!r}, not one "
                         f"of {VARIANTS}")
    can = variants(gated)
    variant = variant or can[0]
    if variant not in can:
        raise ValueError(f"rglru_gated: the {variant} variant cannot take "
                         f"the gated entry")
    if states and not gated:
        raise ValueError("rglru_scan: only the gated entry keeps states")
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
    if states < 0 or states & (states - 1) or states % (T // G):
        raise ValueError(f"rglru_gated: states every {states} steps is not a "
                         f"power of two that is a multiple of the tile's "
                         f"{T // G} steps a thread")
    return Plan("ring", C * G, B * _cdiv(W, C), C, T, G, P, copy, smem)


@functools.cache
def _fns():
    """The C entry points, their library built and loaded at first use."""
    lib = _build.library("rglru_scan")
    lib.rglru_scan_fwd.argtypes = [_vp] * 3 + [_i] * 4 + [_vp]
    lib.rglru_scan_ring_fwd.argtypes = [_vp] * 3 + [_i] * 9 + [_vp]
    lib.rglru_gated_fwd.argtypes = [_vp] * 10 + [_i] * 10 + [_vp]
    lib.rglru_gated_bwd.argtypes = [_vp] * 18 + [_i] * 5 + [_vp] * 2
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
           state: Optional[torch.Tensor],
           states: Optional[torch.Tensor] = None, every: int = 0) -> None:
    """Device, dtype, shape and layout checks of either wrapper, on every
    device (so that the plain CPU path refuses what the kernel would):
    ``same`` must match ``first`` (B, S, W) in shape and dtype, ``vectors``
    be (W,) fp32, ``state`` (B, W) fp32, ``states`` (the forward's kept
    states) (B, ceil(S / every), W) fp32."""
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {first.device}")
    if first.dim() != 3:
        raise ValueError(f"{what}: {tuple(first.shape)} is not (B, S, W)")
    code(first, what)
    B, S, W = first.shape
    want = {**{n: (first.shape, first.dtype) for n in same},
            **{n: ((W,), torch.float32) for n in vectors}}
    tensors = {**same, **vectors}
    if state is not None:
        want["h0"] = ((B, W), torch.float32)
        tensors["h0"] = state
    if states is not None:
        want["states"] = ((B, _cdiv(S, every), W), torch.float32)
        tensors["states"] = states
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
                tile: Optional[Tuple[int, int, int, int]] = None,
                states_every: int = 0) -> Tuple[torch.Tensor, ...]:
    """xa = xc @ w_a, xi = xc @ w_i, xc: (B, S, W) in the model's dtype;
    b_a, b_i, lam (the ``lambda`` param): (W,) fp32; h0: (B, W) fp32 or
    None (zero) -> (h (B, S, W) in xc's dtype, h_last (B, W) fp32), where
    ``r = sigmoid(xa + b_a)``, ``i = sigmoid(xi + b_i)``,
    ``a = exp(8 r log_a_hat)`` with ``log_a_hat = -softplus(lam)``,
    ``b = sqrt(max(1 - a^2, 1e-12)) i xc`` and ``h[t] = a[t] h[t-1] + b[t]``;
    h_last is the last state before rounding.  ``tile`` forces the ring's
    (channels, steps, stages, split); ``states_every`` also returns the
    fp32 state entering every ``states_every``-th step, (B, ceil(S /
    states_every), W) (what the backward reads; chip_smoke.py checks it):
    the models pass neither.  Under grad mode with an input requiring grad,
    a CUDA call goes through ``RGLRUGatedFn`` (backward:
    :func:`rglru_gated_bwd`)."""
    _check("rglru_gated", xc, {"xa": xa, "xi": xi},
           {"b_a": b_a, "b_i": b_i, "lam": lam}, h0)
    B, S, W = xc.shape
    if S == 0:
        raise ValueError("rglru_gated: no steps")
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (xa, xi, xc, b_a, b_i, lam, h0))
    if grad and states_every:
        raise ValueError("rglru_gated: under autograd the states are "
                         "RGLRUGatedFn's")
    fake = _fake.is_fake(xc)
    how = plan(B, S, W, xc.dtype, gated=True,
               align=16 if fake else _align((xa, xi, xc)),
               tile=tile, states=BWD_STEPS if grad else states_every)
    if xc.device.type == "cpu" and not fake:
        out = rglru_gated_ref(xa, xi, xc, b_a, b_i, lam, h0)
        if states_every:
            return (*out, rglru_states_ref(xa, xi, xc, b_a, b_i, lam, h0,
                                           states_every))
        return out
    return _gated_cuda(xa, xi, xc, b_a, b_i, lam, h0, how, grad,
                       states_every)


def _gated_cuda(xa, xi, xc, b_a, b_i, lam, h0, how: Plan, grad: bool,
                states_every: int = 0):
    """The CUDA route: under autograd ``RGLRUGatedFn`` (which keeps the
    states), else the forward launch, keeping states only when asked (no
    serving call asks)."""
    if grad:
        return RGLRUGatedFn.apply(xa, xi, xc, b_a, b_i, lam, h0, how)
    h, h_last, states = _gated_fwd(xa, xi, xc, b_a, b_i, lam, h0, how,
                                   states_every)
    return (h, h_last) if states is None else (h, h_last, states)


def _gated_fwd(xa, xi, xc, b_a, b_i, lam, h0, how: Plan, every: int = 0):
    """The gated entry's launch on checked CUDA tensors: (h, h_last, the
    states entering every ``every``-th step, or None when ``every`` is 0)."""
    B, S, W = xc.shape
    h = torch.empty_like(xc)
    h_last = torch.empty(B, W, dtype=torch.float32, device=xc.device)
    states = (torch.empty(B, _cdiv(S, every), W, dtype=torch.float32,
                          device=xc.device) if every else None)
    if _fake.is_fake(xc):
        _fake.rglru_gated(xc, h0)
        return h, h_last, states
    err = _fns().rglru_gated_fwd(
        xa.data_ptr(), xi.data_ptr(), xc.data_ptr(), b_a.data_ptr(),
        b_i.data_ptr(), lam.data_ptr(),
        None if h0 is None else h0.data_ptr(), h.data_ptr(),
        h_last.data_ptr(), None if states is None else states.data_ptr(),
        code(xc, "rglru_gated xc"), B, S, W, how.channels, how.steps,
        how.stages, how.split, how.copy_bytes, every,
        torch.cuda.current_stream(xc.device).cuda_stream)
    _build.check(err, "rglru_gated_fwd")
    rglru_gated.launches += 1
    return h, h_last, states


rglru_gated.launches = 0


class RGLRUGatedFn(torch.autograd.Function):
    """The gated RG-LRU on the card under autograd: the forward kernel,
    keeping the fp32 state entering every BWD_STEPS-th step, then the
    backward kernel from the saved inputs and those states (it recomputes
    a, b and h in fp32; the rounded h is not saved)."""

    @staticmethod
    def forward(ctx, xa, xi, xc, b_a, b_i, lam, h0, how):
        h, h_last, states = _gated_fwd(xa, xi, xc, b_a, b_i, lam, h0, how,
                                       BWD_STEPS)
        ctx.save_for_backward(xa, xi, xc, b_a, b_i, lam, h0, states)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        xa, xi, xc, b_a, b_i, lam, h0, states = ctx.saved_tensors
        grads = rglru_gated_bwd(xa, xi, xc, b_a, b_i, lam, h0,
                                dh.contiguous(), dh_last.contiguous(),
                                states)
        return (*grads, None)


def rglru_gated_bwd(xa: torch.Tensor, xi: torch.Tensor, xc: torch.Tensor,
                    b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                    h0: Optional[torch.Tensor], dh: torch.Tensor,
                    dh_last: Optional[torch.Tensor] = None,
                    states: Optional[torch.Tensor] = None, *, marks=None
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradients of :func:`rglru_gated` for dh (B, S, W) in xc's dtype
    and dh_last (B, W) fp32 (None: zero): (dxa, dxi, dxc in xc's dtype;
    db_a, db_i, dlam (W,) fp32; dh0 (B, W) fp32, None without h0).
    ``states``: the forward's fp32 state entering every BWD_STEPS-th step
    (``rglru_gated(..., states_every=BWD_STEPS)``).  A CPU tensor takes
    ``rglru_gated_bwd_ref``, which holds the states, when given, to its
    own; a CUDA tensor needs them and launches the backward kernel (one
    read of each input: a, b and h recomputed in fp32 with the forward's
    arithmetic from the states, chunks of BWD_STEPS steps chained in
    reverse order, the (W,) sums in fixed order), adding one to
    ``rglru_gated_bwd.launches``.  ``marks``: three
    ``torch.cuda.Event`` (see ``_build.event_marks``) recorded before its
    scratch's memset, after it and after the launch, so that chip_smoke.py
    times the two apart."""
    _check("rglru_gated_bwd", xc, {"xa": xa, "xi": xi, "dh": dh},
           {"b_a": b_a, "b_i": b_i, "lam": lam}, h0, states, BWD_STEPS)
    if dh_last is not None:
        _check("rglru_gated_bwd", xc, {}, {}, dh_last)
    if _fake.is_fake(xc):
        _fake.rglru_gated_bwd(xc, h0, dh_last, BWD_STEPS)
        f32 = lambda: torch.empty_like(lam)
        return (torch.empty_like(xc), torch.empty_like(xc),
                torch.empty_like(xc), f32(), f32(), f32(),
                None if h0 is None else torch.empty_like(h0))
    if xc.device.type == "cpu":
        return rglru_gated_bwd_ref(xa, xi, xc, b_a, b_i, lam, h0, dh,
                                   dh_last, states, BWD_STEPS)
    if states is None:
        raise ValueError("rglru_gated_bwd: a CUDA call needs the forward's "
                         "states (rglru_gated(..., states_every=BWD_STEPS))")
    B, S, W = xc.shape
    K = _cdiv(S, BWD_STEPS)
    dev = xc.device
    dxa, dxi, dxc = (torch.empty_like(xc) for _ in range(3))
    db_a, db_i, dlam = (torch.empty(W, dtype=torch.float32, device=dev)
                        for _ in range(3))
    dh0 = None if h0 is None else torch.empty_like(h0)
    part = torch.empty(3, B, K, W, dtype=torch.float64, device=dev)
    sync = torch.empty(4 + W + B * K * W, dtype=torch.int32, device=dev)
    vec = int(W % (8 // xc.element_size()) == 0 and _align(
        (xa, xi, xc, dh, dxa, dxi, dxc)) >= 8)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _fns().rglru_gated_bwd(
        *(ptr(t) for t in (xa, xi, xc, dh, b_a, b_i, lam, states, dh_last,
                           dxa, dxi, dxc, db_a, db_i, dlam, dh0, part,
                           sync)),
        code(xc, "rglru_gated_bwd xc"), B, S, W, vec,
        torch.cuda.current_stream(dev).cuda_stream,
        _build.event_marks(marks, 3))
    _build.check(err, "rglru_gated_bwd")
    rglru_gated_bwd.launches += 1
    return dxa, dxi, dxc, db_a, db_i, dlam, dh0


rglru_gated_bwd.launches = 0
