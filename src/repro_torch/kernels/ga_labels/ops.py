"""GA group labels: wrapper of ``csrc/ga_labels.cu``.

Replaces the reference's jitted-JAX label pass
``repro/core/population.py:_build_jax_labels`` (numpy twin
``PopulationEvaluator._labels_np``).  A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel, and every launch adds one
to ``ga_labels.launches`` and to its variant's count in
``ga_labels.variant_launches`` (``shared``: a row's working words in shared
memory; ``global``: in a scratch row in device memory, for rows too long
for shared memory).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ga_labels.ref import LabelTables, ga_labels_ref

_i = ctypes.c_int
_p = ctypes.c_void_p
VARIANTS = ("shared", "global")


@functools.cache
def _lib():
    """The library, built and loaded at first use, its entry points typed."""
    lib = _build.library("ga_labels")
    lib.ga_labels_fwd.argtypes = [_p, _p, _p, _i, _i, _i, _p, _p, _i, _p, _p,
                                  _p, _i, _p]
    lib.ga_labels_fwd.restype = _i
    lib.ga_labels_max_shared_words.argtypes = []
    lib.ga_labels_max_shared_words.restype = _i
    return lib


def row_words(tables: LabelTables) -> int:
    """int32 words a genome row works in: its labels, the pointer jump's
    second buffer, and the two end labels of each extra edge."""
    return 2 * tables.n + 2 * tables.xu.numel()


def max_shared_words() -> int:
    """Most words a row may take in the shared-memory variant on the
    current card."""
    n = _lib().ga_labels_max_shared_words()
    if n <= 0:
        raise RuntimeError("ga_labels: cannot read the card's shared memory "
                           "size")
    return n


def ga_labels(bits: torch.Tensor, tables: LabelTables) -> torch.Tensor:
    """bits (P, m) uint8 (0/1) -> labels (P, n) int32: each node's group
    label, computed as the reference's numpy engine does.  A CUDA launch
    keeps a row's working words in shared memory when they fit, else in a
    scratch row in device memory."""
    if bits.device.type == "cpu":
        return ga_labels_ref(bits, tables).to(torch.int32)
    if bits.device.type != "cuda":
        raise ValueError(f"ga_labels: unsupported device {bits.device}")
    if bits.dtype != torch.uint8 or bits.dim() != 2 \
            or bits.shape[1] != tables.m or not bits.is_contiguous():
        raise ValueError(f"ga_labels: bits must be contiguous (P, {tables.m})"
                         f" uint8, got {tuple(bits.shape)} {bits.dtype}")
    ints = (tables.chain_nodes, tables.chain_eids, tables.extra_eids,
            tables.xu, tables.xv)
    if any(x.device != bits.device or x.dtype != torch.int32
           or not x.is_contiguous() for x in ints):
        raise ValueError("ga_labels: tables must be contiguous int32 on the "
                         "bits' device")
    words = row_words(tables)
    variant = "shared" if words <= max_shared_words() else "global"
    P = bits.shape[0]
    out = torch.empty((P, tables.n), dtype=torch.int32, device=bits.device)
    if P == 0 or tables.n == 0:
        return out
    scratch = None if variant == "shared" else torch.empty(
        (P, words), dtype=torch.int32, device=bits.device)
    err = _lib().ga_labels_fwd(
        bits.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), P, tables.m,
        tables.n, tables.chain_nodes.data_ptr(),
        tables.chain_eids.data_ptr(), tables.chain_nodes.numel(),
        tables.extra_eids.data_ptr(), tables.xu.data_ptr(),
        tables.xv.data_ptr(), tables.xu.numel(),
        torch.cuda.current_stream(bits.device).cuda_stream)
    _build.check(err, "ga_labels_fwd")
    ga_labels.launches += 1
    ga_labels.variant_launches[variant] += 1
    return out


ga_labels.launches = 0
ga_labels.variant_launches = dict.fromkeys(VARIANTS, 0)
