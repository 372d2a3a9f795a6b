"""GA group labels: wrapper of ``csrc/ga_labels.cu``.

Replaces the reference's jitted-JAX label pass
``repro/core/population.py:_build_jax_labels`` (numpy twin
``PopulationEvaluator._labels_np``).  A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the variant that :func:`plan` names, and
every launch adds one to ``ga_labels.launches``, to its variant's count in
``ga_labels.variant_launches`` (under a lock: the daemon's workers launch
from several threads at once) and to the launching thread's own tally,
:func:`thread_launches`:

- ``warp``: one warp per genome row, several rows a block, the row's bits
  packed into registers, its working words in the warp's slice of shared
  memory;
- ``block``: one block per genome row, its words in shared memory (the
  port's first design);
- ``global``: the block variant with the row's words in a scratch row in
  device memory, for rows too long for shared memory.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ga_labels.ref import LabelTables, ga_labels_ref

_i = ctypes.c_int
_p = ctypes.c_void_p
VARIANTS = ("warp", "block", "global")
MAX_ROWS = 8            # warps (rows) a block of the warp variant
# blocks of MAX_ROWS rows whose shared memory an SM must hold for the warp
# variant to take less time than the block one: 3 (24 warps), measured by
# chip_smoke.py --label-sweep on an H100
MIN_BLOCKS = 3
BIT_WORDS = (1, 2, 4)   # words of packed bits a lane holds (1024 edges each)
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def thread_launches() -> int:
    """The launches the calling thread has made (a population engine's own
    count, exact when other threads launch too)."""
    return getattr(_TALLY, "launches", 0)


def _count(variant: str) -> None:
    """Count one launch of ``variant``: in the totals, under the lock, and
    in the calling thread's tally."""
    with _COUNT_LOCK:
        ga_labels.launches += 1
        ga_labels.variant_launches[variant] += 1
    _TALLY.launches = thread_launches() + 1


@dataclasses.dataclass(frozen=True)
class Card:
    """What the plan reads of a card: the int32 words of shared memory a
    block may take (the block variant's static carry taken off) and its
    streaming multiprocessors."""
    shared_words: int
    sms: int


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which variant labels a batch and, for ``warp``, its launch shape:
    ``rows_per_block`` warps a block, ``bit_words`` words of packed bits a
    lane, ``shared_words`` int32 words of shared memory a block (the static
    tables and the rows' words); a launch takes ceil(P / rows_per_block)
    blocks."""
    variant: str
    rows_per_block: int = 0
    bit_words: int = 0
    shared_words: int = 0


def row_words(n: int, n_extra: int) -> int:
    """int32 words a genome row works in: its labels, the pointer jump's
    second buffer, and the two end labels of each extra edge."""
    return 2 * n + 2 * n_extra


def _check(variant: Optional[str]) -> None:
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"ga_labels: unknown variant {variant!r}, not one "
                         f"of {VARIANTS}")


def _bit_words(m: int) -> int:
    """Words of packed bits a lane holds for m edges (0: too many)."""
    return next((k for k in BIT_WORDS if m <= 1024 * k), 0)


def variants(n: int, m: int, n_extra: int, max_shared_words: int) -> tuple:
    """The variants that can label a graph of n nodes, m edges and n_extra
    non-chain edges, in the plan's order: ``warp`` when the row's bits fit
    BIT_WORDS words a lane, its extra edges a bit each of a lane's word
    (at most 1024), and the static tables (n + 3 n_extra words) and one
    row's words fit shared memory; ``block`` when a row's words do;
    ``global`` always."""
    words = row_words(n, n_extra)
    fits = {"warp": _bit_words(m) > 0 and n_extra <= 1024
            and n + 3 * n_extra + words <= max_shared_words,
            "block": words <= max_shared_words, "global": True}
    return tuple(v for v in VARIANTS if fits[v])


@functools.lru_cache(maxsize=1024)
def plan(P: int, n: int, m: int, n_extra: int, card: Card,
         variant: Optional[str] = None) -> Plan:
    """The variant for P genome rows of a graph with n nodes, m edges and
    n_extra non-chain edges on ``card`` (pure Python, no device; cached: a
    call per launch).

    ``warp`` where it can take the graph and MIN_BLOCKS of its blocks of
    MAX_ROWS rows fit a block's shared memory (the tables and MAX_ROWS
    rows' words at most shared_words / MIN_BLOCKS; an SM holds about as
    much as a block may take): the warp variant is latency-bound, and with
    fewer of its warps an SM the block variant takes less time; else the
    first other variant that can (:func:`variants`).  The warp variant's
    rows per block are the largest power of two up to MAX_ROWS that leaves
    at least one block per SM (on an H100's 132 SMs, 63 rows take 63 blocks
    of one warp, 65536 take 8192 of eight) and that shared memory holds.
    ``variant`` forces one, and raises if it cannot take the batch."""
    _check(variant)
    shared = card.shared_words
    can = variants(n, m, n_extra, shared)
    words, tables = row_words(n, n_extra), n + 3 * n_extra
    if variant is None:
        fits = tables + MAX_ROWS * words <= shared // MIN_BLOCKS
        variant = next(v for v in can if v != "warp" or fits)
    if variant not in can:
        raise ValueError(f"ga_labels: the {variant} variant cannot take a "
                         f"graph of {n} nodes, {m} edges, {n_extra} extra "
                         f"({shared} shared words)")
    if variant != "warp":
        return Plan(variant)
    rows = 1
    while (2 * rows <= MAX_ROWS and -(-P // (2 * rows)) >= card.sms
           and tables + 2 * rows * words <= shared):
        rows *= 2
    return Plan("warp", rows, _bit_words(m), tables + rows * words)


@functools.cache
def _lib():
    """The library, built and loaded at first use, its entry points typed."""
    lib = _build.library("ga_labels")
    lib.ga_labels_fwd.argtypes = [_p, _p, _p, _i, _i, _i, _p, _p, _i, _p, _p,
                                  _p, _i, _i, _p]
    lib.ga_labels_warp_fwd.argtypes = [_p, _p, _i, _i, _i, _p, _p, _p, _p,
                                       _i, _i, _i, _i, _i, _p]
    lib.ga_labels_max_shared_words.argtypes = []
    for f in (lib.ga_labels_fwd, lib.ga_labels_warp_fwd,
              lib.ga_labels_max_shared_words):
        f.restype = _i
    return lib


_CARDS: Dict[int, Card] = {}


def card(device: Optional[torch.device] = None) -> Card:
    """The :class:`Card` of ``device`` (default: the current CUDA device),
    read from it once per device."""
    index = torch.cuda.current_device() if device is None or \
        device.index is None else device.index
    if index not in _CARDS:
        with torch.cuda.device(index):
            words = _lib().ga_labels_max_shared_words()
        if words <= 0:
            raise RuntimeError("ga_labels: cannot read the card's shared "
                               "memory size")
        props = torch.cuda.get_device_properties(index)
        _CARDS[index] = Card(words, props.multi_processor_count)
    return _CARDS[index]


def ga_labels(bits: torch.Tensor, tables: LabelTables, *,
              variant: Optional[str] = None) -> torch.Tensor:
    """bits (P, m) uint8 (0/1) -> labels (P, n) int32: each node's group
    label, computed as the reference's numpy engine does.  ``variant``
    forces a kernel (``warp``, ``block`` or ``global``) instead of the
    plan's choice; the engine never passes it."""
    _check(variant)
    if bits.device.type == "cpu":
        return ga_labels_ref(bits, tables).to(torch.int32)
    if bits.device.type != "cuda":
        raise ValueError(f"ga_labels: unsupported device {bits.device}")
    if bits.dtype != torch.uint8 or bits.dim() != 2 \
            or bits.shape[1] != tables.m or not bits.is_contiguous():
        raise ValueError(f"ga_labels: bits must be contiguous (P, {tables.m})"
                         f" uint8, got {tuple(bits.shape)} {bits.dtype}")
    ints = tables[2:]
    if any(x.device != bits.device or x.dtype != torch.int32
           or not x.is_contiguous() for x in ints):
        raise ValueError("ga_labels: tables must be contiguous int32 on the "
                         "bits' device")
    P, n, n_extra = bits.shape[0], tables.n, tables.xu.numel()
    on = card(bits.device)
    how = plan(P, n, tables.m, n_extra, on, variant)
    out = torch.empty((P, n), dtype=torch.int32, device=bits.device)
    if P == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(bits.device).cuda_stream
    extra = (tables.extra_eids.data_ptr(), tables.xu.data_ptr(),
             tables.xv.data_ptr(), n_extra)
    if how.variant == "warp":
        err = _lib().ga_labels_warp_fwd(
            bits.data_ptr(), out.data_ptr(), P, tables.m, n,
            tables.chain_into.data_ptr(), *extra, how.rows_per_block,
            how.bit_words, 4 * how.shared_words, 4 * on.shared_words, stream)
        _build.check(err, "ga_labels_warp_fwd")
    else:
        scratch = None if how.variant == "block" else torch.empty(
            (P, row_words(n, n_extra)), dtype=torch.int32,
            device=bits.device)
        err = _lib().ga_labels_fwd(
            bits.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), P, tables.m, n,
            tables.chain_nodes.data_ptr(), tables.chain_eids.data_ptr(),
            tables.chain_nodes.numel(), *extra, 4 * on.shared_words, stream)
        _build.check(err, "ga_labels_fwd")
    _count(how.variant)
    return out


ga_labels.launches = 0
ga_labels.variant_launches = dict.fromkeys(VARIANTS, 0)
