"""The kernels under a dry run: shapes and counted work, no launch.

``launch/dryrun.py`` traces a step with fake tensors (``FakeTensorMode``).
A kernel wrapper given a fake tensor takes the card's route whatever the
tensor's device (the autograd Function of a training call, the plan's
kernel), and where it would launch it returns empty outputs of the
kernel's shapes and records the call's work here instead: the operations
and the bytes that the bound of the kernel's row in ``PERF.md`` counts
(``chip_smoke.py``'s formulas: each input read once, each output written
once).  A real tensor, on the card or the CPU, never takes this route.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: kernel name -> {"calls", "flops", "bytes"} of the current trace
WORK: Dict[str, Dict[str, int]] = {}


def is_fake(t: torch.Tensor) -> bool:
    """Whether a wrapper records ``t``'s call instead of launching it."""
    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def tracing():
    """Yields ``WORK``, cleared, to collect the fake calls of a trace."""
    WORK.clear()
    yield WORK


def record(name: str, flops: int, nbytes: int) -> None:
    w = WORK.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
    w["calls"] += 1
    w["flops"] += int(flops)
    w["bytes"] += int(nbytes)


def esize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt, device="meta").element_size()


def rmsnorm(x: torch.Tensor) -> None:
    n, d = x.numel() // x.shape[-1], x.shape[-1]
    record("rmsnorm", 4 * n * d, (2 * n * d + d) * esize(x.dtype))


def rmsnorm_bwd(x: torch.Tensor) -> None:
    n, d = x.numel() // x.shape[-1], x.shape[-1]
    record("rmsnorm_bwd", 10 * n * d, (3 * n * d + 2 * d) * esize(x.dtype))


@functools.lru_cache(maxsize=4096)
def visible(Sq: int, Skv: int, causal: bool, window: int, chunk: int,
            q_offset: int, kv_len: int, rolling: bool) -> tuple:
    """(unmasked (query, key) pairs, key slots any query sees) of one
    (batch, head).  Query i sits at q_offset + i; key slot j at position j,
    or in a rolling buffer (``rolling``) at the last position p <=
    q_offset + Sq - 1 with p % Skv == j."""
    last = q_offset + Sq - 1
    keys = [last - (last - j) % Skv if rolling else j for j in range(kv_len)]
    if not rolling:
        pairs, seen = 0, 0
        for i in range(Sq):
            p = q_offset + i
            lo = max(0, p - window + 1 if window else 0,
                     p // chunk * chunk if chunk else 0)
            hi = min(kv_len, p + 1 if causal else kv_len)
            pairs += max(0, hi - lo)
        lo = max(0, q_offset - window + 1 if window else 0,
                 q_offset // chunk * chunk if chunk else 0)
        hi = min(kv_len, last + 1 if causal else kv_len)
        seen = max(0, hi - lo)
        return pairs, seen
    pairs, seen = 0, set()
    for i in range(Sq):
        p = q_offset + i
        for j, k in enumerate(keys):
            if k < 0 or (causal and k > p) or (window and k <= p - window) \
                    or (chunk and k // chunk != p // chunk):
                continue
            pairs += 1
            seen.add(j)
    return pairs, len(seen)


def flash(q, k, *, causal: bool, window: int, chunk: int, q_offset: int,
          kv_len: Optional[int], rolling: bool, impl: str) -> int:
    """Records a forward; returns its flops (the backward's are 2.5x)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    pairs, seen = visible(Sq, Skv, causal, window, chunk, q_offset,
                          Skv if kv_len is None else kv_len, rolling)
    flops = 4 * D * B * Hq * pairs
    record(f"flash_attention_{impl}", flops,
           (2 * B * Sq * Hq * D + 2 * B * seen * Hkv * D) * esize(q.dtype))
    return flops


def flash_bwd(q, k, *, causal: bool, window: int, chunk: int, o_lo: bool,
              impl: str) -> None:
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    pairs, _ = visible(Sq, Skv, causal, window, chunk, 0, Skv, False)
    record(f"flash_attention_bwd_{impl}", 2.5 * 4 * D * B * Hq * pairs,
           ((4 + o_lo) * B * Sq * Hq * D + 4 * B * Skv * Hkv * D)
           * esize(q.dtype) + 4 * B * Hq * Sq)


def rglru_gated(xc, h0) -> None:
    B, S, W = xc.shape
    n = B * S * W
    record("rglru_gated", 30 * n, 4 * n * esize(xc.dtype) + 3 * W * 4
           + (2 if h0 is not None else 1) * B * W * 4)


def rglru_gated_bwd(xc, h0, dh_last, steps: int) -> None:
    B, S, W = xc.shape
    n = B * S * W
    rows = B * -(-S // steps) * W
    record("rglru_gated_bwd", 50 * n, 7 * n * esize(xc.dtype) + 6 * W * 4
           + ((h0 is not None) + (dh_last is not None)) * B * W * 4
           + rows * 4)


def mamba_scan(da, c) -> None:
    B, S, Di, N = da.shape
    record("mamba_scan", 4 * da.numel(),
           (2 * da.numel() + c.numel() + B * S * Di) * esize(da.dtype)
           + B * Di * N * 4)


def mamba_scan_bwd(da) -> None:
    B, S, Di, N = da.shape
    n = da.numel()
    record("mamba_scan_bwd", 8 * n,
           (2 * n + B * S * (N + Di)) * esize(da.dtype)
           + (2 * n + B * S * N) * 4)
