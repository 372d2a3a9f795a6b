"""Flash attention, forward: wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/ops.py:flash_attention`` and its
Pallas kernel ``flash_attention_kernel``.  Model layout (B, S, H, D), no
transposes.  A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel, and every launch adds one to
``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dtypes import code
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_i = ctypes.c_int


@functools.cache
def _fn():
    """The C entry point, its library built and loaded at first use."""
    lib = _build.library("flash_attention")
    f = lib.flash_attention_fwd
    f.argtypes = [ctypes.c_void_p] * 5 + [_i] * 12 + [ctypes.c_float,
                                                       ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    k_pos: Optional[torch.Tensor] = None):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Query i sits at position ``q_offset + i`` (an int read at run time, not
    compiled in), key slot j at position j, or at ``k_pos[j]`` when the
    int32 vector ``k_pos`` (Skv,) is given (a rolling cache buffer; a
    negative position is masked).  Only the first ``kv_len`` slots (default:
    all) are read; the rest are masked, as the reference masks unwritten
    cache slots.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset, kv_len=kv_len,
                             k_pos=k_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else int(kv_len)
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: head_dim {D} must be one of "
                         f"{HEAD_DIMS} and Hq={Hq} a multiple of Hkv={Hkv}")
    if not 0 <= kv_len <= Skv or q_offset < 0 or window < 0 or chunk < 0:
        raise ValueError("flash_attention: need 0 <= kv_len <= Skv and "
                         "non-negative q_offset, window, chunk")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if any(t.device != q.device or not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and on "
                         "one device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: k and v must be 16-byte aligned")
    if k_pos is not None and (
            k_pos.shape != (Skv,) or k_pos.dtype != torch.int32
            or k_pos.device != q.device or not k_pos.is_contiguous()):
        raise ValueError(f"flash_attention: k_pos must be a contiguous int32 "
                         f"({Skv},) tensor on {q.device}")
    o = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if k_pos is None else k_pos.data_ptr(),
                code(q, "flash_attention q"), B, Sq, Skv, Hq, Hkv, D,
                int(causal), window, chunk, int(q_offset), kv_len,
                1.0 / math.sqrt(D),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
