"""Flash attention, forward: wrapper of the four CUDA kernels.

Replaces ``repro/kernels/flash_attention/ops.py:flash_attention`` and its
Pallas kernel ``flash_attention_kernel``.  Model layout (B, S, H, D), no
transposes.  A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel that :func:`plan` names, and every call adds one to
``flash_attention.launches`` and to its kernel's entry of
``flash_attention.impl_launches``:

- ``warp_decode`` (``csrc/flash_decode.cu``): at most 8 query rows and at
  most ``R_MAX`` of them per kv head (G * Sq), every dtype and head_dim of
  ``HEAD_DIMS``; a block holds all the rows of a kv head and its warps
  take the keys; one split writes the output itself;
- ``split_decode`` (same file): the other calls of at most 8 query rows;
  a block scores 16 rows of a kv head against 64-key tiles; the keys are
  split over blocks and the splits merged by a second small kernel;
- ``tc_prefill`` (``csrc/flash_prefill_tc.cu``): bf16 at head_dim 64, 96,
  128 or 256 without key positions, on the tensor cores (wgmma, TMA);
- ``simt`` (``csrc/flash_attention.cu``): the rest of prefill (fp32, bf16 at
  head_dim 16 or 32, key positions), on the fp32 cores.

Training: on CUDA tensors, a call under grad mode where q, k or v requires
grad goes through ``FlashAttentionFn``.  Its forward is the prefill kernel
of the plan (``tc_prefill`` or ``simt``; a call of at most 8 query rows
goes to ``simt``: the decode kernels write no log-sum-exp and never run
under autograd), which also writes each row's log-sum-exp (counted in
``flash_attention.lse_launches``) and, on ``tc_prefill``, O's rounding
residual ``o_lo`` (bf16 of the fp32 output less the bf16 output), so that
the backward's row deltas are the unrounded output's; its backward is
``flash_attention_bwd``,
counted in its ``launches`` and by kernel in its ``impl_launches``, which
launches the kernel :func:`plan_bwd` names:

- ``tc`` (``csrc/flash_bwd_tc.cu``): bf16 at head_dim 64, 96, 128 or 256,
  with or without a window, on the tensor cores (wgmma, TMA; at 256 two
  warpgroups split D); P enters its product as bf16, dS as two bf16 terms
  (hi + lo), a rounding fixed in the kernel;
- ``simt`` (``csrc/flash_attention_bwd.cu``): fp32 and bf16 at head_dim 16
  or 32, at every mask, on the fp32 cores.

The backward takes the training path's masks (causal, window, chunk or
none, from position 0, every key written) at every head_dim of
``BWD_HEAD_DIMS``: key positions, ``q_offset``/``kv_len`` or a forced
decode kernel raise under grad (:func:`check_grad_call`), and nothing falls
back to another kernel or to the plain version.  A CPU tensor's plain
version is differentiated by autograd.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, _fake
from repro_torch.kernels._dtypes import code
from repro_torch.kernels._grad import KernelRefusal
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

HEAD_DIMS = (16, 32, 64, 96, 128, 256)    # any other head_dim raises
BWD_HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the backward kernels'
BWD_TC_HEAD_DIMS = (64, 96, 128, 256)     # the tensor-core backward's (bf16,
                                          # any mask)
BWD_IMPLS = ("tc", "simt")
TC_HEAD_DIMS = (64, 96, 128, 256)
KV_TILE = 64            # keys of a tile in every kernel
DECODE_MAX_SQ = 8       # query rows the decode kernels take
DECODE_BLOCK_ROWS = 16  # split decode: rows (query heads of a kv head x
                        # queries) a block
MIN_BLOCKS = 2 * 132    # split decode: two blocks per SM of an H100
WARP_BLOCK_ROWS = 8     # warp decode: rows a block (kWDRows in the source)
# warp decode's blocks by their row cap (WarpBlock in the source): up to 2
# rows and up to WARP_BLOCK_ROWS: (warps, K bytes a lane loads a step)
WARP_BLOCKS = {2: (8, 64), WARP_BLOCK_ROWS: (4, 64)}
R_MAX = 8               # warp decode for G * Sq <= R_MAX
WARP_MIN_BLOCKS = 256   # warp decode: fewer blocks a split -> more splits
DECODE_IMPLS = ("warp_decode", "split_decode")
IMPLS = ("split_decode", "warp_decode", "tc_prefill", "simt")
_i = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which kernel runs a call, and how a decode kernel cuts the keys:
    split s covers the 64-key tiles [s * tiles_per_split, (s + 1) *
    tiles_per_split) below ``kv_len``; ``blocks`` is the decode kernel's
    grid (0 for the other kernels)."""
    impl: str
    splits: int = 0
    tiles_per_split: int = 0
    blocks: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, Sq: int, Hq: int, Hkv: int, D: int, dtype: torch.dtype,
         kv_len: int, k_pos: bool = False, impl: Optional[str] = None,
         splits: Optional[int] = None, lse: bool = False) -> Plan:
    """The kernel for a call of these shapes (pure Python, no device);
    raises for a head_dim no kernel takes (not in ``HEAD_DIMS``).

    Decode (``Sq <= 8``) goes to ``warp_decode`` when a kv head has at most
    R_MAX query rows (G * Sq), else to ``split_decode``; ``impl`` forces
    either of them and ``splits`` the number of key splits (for
    chip_smoke.py and the tests).  The keys are cut into splits of whole
    64-key tiles so that the grid (B * Hkv * row groups a split) holds
    MIN_BLOCKS blocks of the split kernel (one tile each unless the cache
    is long enough for more) or WARP_MIN_BLOCKS of the warp kernel (the
    tiles dealt evenly, and one split where the grid is already that
    large: then no merge kernel runs).  ``lse``: the forward of a training
    call, which also writes each row's log-sum-exp: a prefill kernel, so a
    call of at most 8 query rows goes to ``simt`` (no decode kernel may be
    forced)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} must be one of "
                         f"{HEAD_DIMS}")
    if impl is not None and (impl not in DECODE_IMPLS or Sq > DECODE_MAX_SQ):
        raise ValueError(f"flash_attention: impl {impl!r} can be forced only "
                         f"as one of {DECODE_IMPLS}, at most "
                         f"{DECODE_MAX_SQ} query rows")
    if lse and (impl or splits):
        raise ValueError("flash_attention: a decode kernel writes no "
                         "log-sum-exp and cannot run under autograd")
    if Sq <= DECODE_MAX_SQ and lse:
        return Plan("simt")
    if Sq <= DECODE_MAX_SQ:
        rows = Hq // Hkv * Sq
        if impl is None:
            impl = "warp_decode" if rows <= R_MAX else "split_decode"
        warp = impl == "warp_decode"
        base = B * Hkv * _cdiv(rows, WARP_BLOCK_ROWS if warp
                               else DECODE_BLOCK_ROWS)
        tiles = _cdiv(kv_len, KV_TILE)
        if splits is None and not warp:
            per = max(1, tiles // _cdiv(MIN_BLOCKS, base))
        else:                  # splits of near-equal tile counts
            n = splits or _cdiv(WARP_MIN_BLOCKS, base)
            per = max(1, _cdiv(tiles, max(1, min(n, tiles))))
        n = max(1, _cdiv(tiles, per))
        return Plan(impl, n, per, base * n)
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS and not k_pos:
        return Plan("tc_prefill")
    return Plan("simt")


def plan_bwd(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int,
             dtype: torch.dtype, impl: Optional[str] = None) -> str:
    """The backward kernel for a call of these shapes (pure Python, no
    device): ``tc`` for bf16 at a head_dim of ``BWD_TC_HEAD_DIMS``, else
    ``simt``; both take every mask, a window included.  ``impl`` forces one
    (chip_smoke.py checks both where both take a call) and raises where
    that kernel does not take the call; a head_dim outside
    ``BWD_HEAD_DIMS`` raises."""
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {D} must be one of "
                         f"{BWD_HEAD_DIMS}")
    tc = dtype == torch.bfloat16 and D in BWD_TC_HEAD_DIMS
    if impl is None:
        return "tc" if tc else "simt"
    if impl not in BWD_IMPLS or (impl == "tc" and not tc):
        raise ValueError(f"flash_attention_bwd: impl {impl!r} does not take "
                         f"{dtype} at head_dim {D} (tc: bf16 at "
                         f"{BWD_TC_HEAD_DIMS}; simt: {BWD_HEAD_DIMS})")
    return impl


def check_grad_call(D: int, Skv: int, *, window: int = 0,
                    k_pos: bool = False, q_offset: int = 0,
                    kv_len: Optional[int] = None, impl: Optional[str] = None,
                    splits: Optional[int] = None) -> None:
    """Raise ``KernelRefusal`` for a call under autograd that the
    backward kernels do not take: key positions, ``q_offset`` or ``kv_len``
    short of Skv, a forced decode kernel or splits, a head_dim outside
    ``BWD_HEAD_DIMS``.  A window is taken (by either kernel)."""
    if k_pos or q_offset or kv_len not in (None, Skv) or impl or \
            splits or D not in BWD_HEAD_DIMS:
        raise KernelRefusal(
            f"flash_attention under autograd: key positions {k_pos}, "
            f"q_offset {q_offset}, kv_len {kv_len}, forced kernel "
            f"{impl}/{splits} or head_dim {D} is not in the backward "
            f"kernels (window {window} is)")


def warp_decode_layout(rows: int, D: int, dtype: torch.dtype) -> tuple:
    """(warps a block, keys a warp takes per online-softmax step) of
    ``warp_decode`` for ``rows`` = G * Sq (``WarpBlock`` and
    ``WarpLayout::kStep`` in the source): the block of the smallest row cap
    that holds min(rows, WARP_BLOCK_ROWS); warp w takes keys [w * 64 /
    warps, (w + 1) * 64 / warps) of a tile; a lane holds 8 columns of a key,
    the power of two >= D / 8 lanes a key, and each lane loads its block's
    K bytes a step (at most the warp's keys of a tile a step)."""
    cap = min(c for c in WARP_BLOCKS if c >= min(rows, WARP_BLOCK_ROWS))
    warps, load_bytes = WARP_BLOCKS[cap]
    lanes = max(2, 1 << (D // 8 - 1).bit_length())
    words = 8 * torch.tensor([], dtype=dtype).element_size() // 16
    keys = KV_TILE // warps
    u = max(1, min(load_bytes // (16 * words), keys // (32 // lanes)))
    return warps, min(32 // lanes * u, keys)


def _load(lib: str, name: str, argtypes):
    f = getattr(_build.library(lib), name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


@functools.cache
def _simt_fn():
    """The C entry points, their libraries built and loaded at first use."""
    return _load("flash_attention", "flash_attention_fwd",
                 [ctypes.c_void_p] * 5 + [_i] * 12
                 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


@functools.cache
def _decode_fn():
    return _load("flash_decode", "flash_decode_fwd",
                 [ctypes.c_void_p] * 7 + [_i] * 14
                 + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _warp_fn():
    return _load("flash_decode", "flash_decode_warp_fwd",
                 [ctypes.c_void_p] * 7 + [_i] * 14
                 + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _tc_fn():
    return _load("flash_prefill_tc", "flash_prefill_tc_fwd",
                 [ctypes.c_void_p] * 4 + [_i] * 11
                 + [ctypes.c_float] + [ctypes.c_void_p] * 3)


@functools.cache
def _bwd_fn():
    return _load("flash_attention_bwd", "flash_attention_bwd",
                 [ctypes.c_void_p] * 11 + [_i] * 10
                 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


@functools.cache
def _bwd_tc_fn():
    return _load("flash_bwd_tc", "flash_bwd_tc",
                 [ctypes.c_void_p] * 11 + [_i] * 10
                 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


class FlashAttentionFn(torch.autograd.Function):
    """Attention on the card under autograd: the prefill kernel with the
    log-sum-exp (and, on ``tc_prefill``, O's rounding residual), then the
    backward kernel from the saved q, k, v, o, lse and o_lo."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        o, lse, o_lo = _forward(q, k, v, causal=causal, window=window,
                                chunk=chunk, q_offset=0, kv_len=None,
                                k_pos=None, impl=None, splits=None,
                                with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, o_lo)
        ctx.causal, ctx.window, ctx.chunk = causal, window, chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, o_lo = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window, chunk=ctx.chunk,
                                         o_lo=o_lo)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    k_pos: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None,
                    splits: Optional[int] = None):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Query i sits at position ``q_offset + i`` (an int read at run time, not
    compiled in), key slot j at position j, or at ``k_pos[j]`` when the
    int32 vector ``k_pos`` (Skv,) is given (a rolling cache buffer; a
    negative position is masked).  Only the first ``kv_len`` slots (default:
    all) are read; the rest are masked, as the reference masks unwritten
    cache slots.  ``impl`` and ``splits`` force a decode kernel and its key
    splits on a CUDA tensor (see :func:`plan`; chip_smoke.py compares and
    times the kernels with them).  Under grad mode with an input requiring
    grad, a CUDA call goes through ``FlashAttentionFn`` (see the module's
    note) or raises.
    """
    fake = _fake.is_fake(q)
    if q.device.type == "cpu" and not fake:
        return attention_ref(q, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset, kv_len=kv_len,
                             k_pos=k_pos)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_grad_call(q.shape[-1], k.shape[1], window=window,
                        k_pos=k_pos is not None, q_offset=q_offset,
                        kv_len=kv_len, impl=impl, splits=splits)
        return FlashAttentionFn.apply(q, k, v, causal, window, chunk)
    return _forward(q, k, v, causal=causal, window=window, chunk=chunk,
                    q_offset=q_offset, kv_len=kv_len, k_pos=k_pos, impl=impl,
                    splits=splits, with_lse=False)[0]


def _forward(q, k, v, *, causal, window, chunk, q_offset, kv_len, k_pos,
             impl, splits, with_lse):
    """(o, lse (B, Hq, Sq) fp32 or None, o_lo like o or None): the forward
    kernel's launch on CUDA tensors (checks included); ``with_lse`` on
    ``tc_prefill`` also writes o_lo, O's rounding residual."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else int(kv_len)
    if _fake.is_fake(q):
        how = plan(B, Sq, Hq, Hkv, D, q.dtype, kv_len, k_pos is not None,
                   impl, splits, with_lse)
        _fake.flash(q, k, causal=causal, window=window, chunk=chunk,
                    q_offset=q_offset, kv_len=kv_len,
                    rolling=k_pos is not None, impl=how.impl)
        lse = (torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
               if with_lse else None)
        o_lo = (torch.empty_like(q) if with_lse and how.impl == "tc_prefill"
                else None)
        return torch.empty_like(q), lse, o_lo
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} must be a multiple of "
                         f"Hkv={Hkv}")
    if not 0 <= kv_len <= Skv or q_offset < 0 or window < 0 or chunk < 0:
        raise ValueError("flash_attention: need 0 <= kv_len <= Skv and "
                         "non-negative q_offset, window, chunk")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if any(t.device != q.device or not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and on "
                         "one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    if k_pos is not None and (
            k_pos.shape != (Skv,) or k_pos.dtype != torch.int32
            or k_pos.device != q.device or not k_pos.is_contiguous()):
        raise ValueError(f"flash_attention: k_pos must be a contiguous int32 "
                         f"({Skv},) tensor on {q.device}")
    dtype = code(q, "flash_attention q")
    how = plan(B, Sq, Hq, Hkv, D, q.dtype, kv_len, k_pos is not None,
               impl, splits, with_lse)
    o = torch.empty_like(q)
    lse = (torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    o_lo = (torch.empty_like(q) if with_lse and how.impl == "tc_prefill"
            else None)
    kpos = None if k_pos is None else k_pos.data_ptr()
    masks = (int(causal), window, chunk, int(q_offset), kv_len)
    scale = 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if how.impl in DECODE_IMPLS:
        # the splits' partials; one warp_decode split writes o directly
        rows = B * Hq * Sq * how.splits
        if how.impl == "warp_decode" and how.splits == 1:
            rows = 0
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
        part_acc = torch.empty(rows * D, dtype=torch.float32, device=q.device)
        fn, name = ((_warp_fn(), "flash_decode_warp_fwd")
                    if how.impl == "warp_decode"
                    else (_decode_fn(), "flash_decode_fwd"))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 kpos, part_ml.data_ptr(), part_acc.data_ptr(), dtype, B, Sq,
                 Skv, Hq, Hkv, D, *masks, how.splits, how.tiles_per_split,
                 scale, stream)
        _build.check(err, name)
    elif how.impl == "tc_prefill":
        err = _tc_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       B, Sq, Skv, Hq, Hkv, D, *masks, scale, lse_ptr,
                       None if o_lo is None else o_lo.data_ptr(), stream)
        _build.check(err, "flash_prefill_tc_fwd")
    else:
        err = _simt_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), kpos, dtype, B, Sq, Skv, Hq, Hkv, D,
                         *masks, scale, lse_ptr, stream)
        _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.impl_launches[how.impl] += 1
    flash_attention.lse_launches += with_lse
    return o, lse, o_lo


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, chunk: int = 0,
                        impl: Optional[str] = None, marks=None,
                        o_lo: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=causal,
    window=window, chunk=chunk)`` whose output was o and log-sum-exp lse
    (B, Hq, Sq), for the output gradient do; ``o_lo``, O's rounding
    residual where the forward wrote one, goes into the row deltas.  A CPU
    tensor takes ``attention_bwd_ref``; a CUDA tensor launches the kernel
    :func:`plan_bwd` names (``impl`` forces one), each with its delta, dK/dV
    and dQ passes, adding one to
    ``flash_attention_bwd.launches`` and to its kernel's entry of
    ``flash_attention_bwd.impl_launches``.  ``marks``: four
    ``torch.cuda.Event`` (see ``_build.event_marks``) recorded before the
    delta pass and after each pass, so that chip_smoke.py times the passes
    apart.  A build or launch error raises: no call falls back to the other
    kernel."""
    if _fake.is_fake(q):
        how = plan_bwd(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                       q.shape[3], q.dtype, impl)
        _fake.flash_bwd(q, k, causal=causal, window=window, chunk=chunk,
                        o_lo=o_lo is not None, impl=how)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window, chunk=chunk, o_lo=o_lo)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    how = plan_bwd(B, Sq, Skv, Hq, Hkv, D, q.dtype, impl)
    if window < 0 or chunk < 0:
        raise ValueError("flash_attention_bwd: negative window or chunk")
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or \
            o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (B, Hq, Sq) or Hkv == 0 or Hq % Hkv:
        raise ValueError("flash_attention_bwd: shapes do not match")
    if any(t.dtype != q.dtype for t in (k, v, o, do)) or \
            lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: q, k, v, o, do share a dtype; "
                        "lse is fp32")
    if o_lo is not None and (o_lo.shape != q.shape
                             or o_lo.dtype != q.dtype):
        raise ValueError("flash_attention_bwd: o_lo must be like o")
    tensors = (q, k, v, o, lse, do) + (() if o_lo is None else (o_lo,))
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_bwd: inputs must be contiguous and "
                         "on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do) + tensors[6:]):
        raise ValueError("flash_attention_bwd: inputs must be 16-byte "
                         "aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    fn, name = ((_bwd_tc_fn(), "flash_bwd_tc") if how == "tc"
                else (_bwd_fn(), "flash_attention_bwd"))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if o_lo is None else o_lo.data_ptr(),
             *(t.data_ptr() for t in (lse, do, dq, dk, dv, delta)),
             code(q, "flash_attention_bwd q"), B, Sq, Skv, Hq, Hkv, D,
             int(causal), window, chunk, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream,
             _build.event_marks(marks, 4))
    _build.check(err, name)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.impl_launches[how] += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.impl_launches = dict.fromkeys(IMPLS, 0)
flash_attention.lse_launches = 0   # forwards of training calls
flash_attention_bwd.launches = 0
flash_attention_bwd.impl_launches = dict.fromkeys(BWD_IMPLS, 0)
