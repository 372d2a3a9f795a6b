#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and the script exits
non-zero (no phase's failure is caught):

1. device: the card's name and power limit;
2. build: every ``src/repro_torch/csrc/*.cu`` (seven sources) compiled with
   nvcc for sm_90a, all at once; the tensor-core flash prefill's SASS must
   show both products as wgmma (HGMMA) at each head_dim and its loads as
   TMA;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the serve paths' shapes and at small ragged/masked ones, in fp32 and
   bf16, and timed beside its bound and one library call where one exists
   (a yardstick the port never calls): RMSNorm (both forms, at the prefill
   and decode rows of every served model), flash attention (head_dim 128
   and 256, windowed prefill, decode over a wrapped rolling buffer with key
   positions; head_dim 96 at phi-3-vision-4.2b's MHA prefill of 1024 image
   + 1024 text positions and its decode, and ragged cases at D 96 reaching
   each of the three kernels; the SIMT kernel timed in fp32 at phase 5's
   prefill shapes; every case also held to its rows' scale, FLASH_ROW_TOL,
   and the serve decodes shown to fail that check without their newest
   key), the RG-LRU scan (every variant, ``ring`` and ``simple``, forced,
   the plan's the faster at the serve shape), the gated RG-LRU entry (gate
   arithmetic and scan in one kernel, with its final state, from zero and
   from an initial state, at the prefill and decode shapes; timed beside
   today's layer path, the eager gate ops and the ``simple`` scan) and the
   Mamba scan (with its final state); every flash case of at most 8 query
   rows runs
   on both decode kernels, the plan's and the other one forced (the warp
   decode kernel at G 1 and every head_dim, key positions, window, chunk,
   up to 8 queries, B 1 with many splits, one split without the merge
   kernel, and G * Sq at R_MAX and R_MAX + 1), and at phi-3-vision's decode
   both are timed; the GA's group-label kernel (bit-equal to its plain version on
   mobilenet_v3, resnet50, a 1040-node chain with skips, each at 65536
   random genomes of fused-bit density 0.1 and 0.5 with an all-zero and an
   all-one row, on a graph too long for shared memory at 4096, and at the
   engine's batches: 64 genomes of mobilenet_v3, 128 of resnet50).  The
   kernels with variants (RMSNorm: ``vector``, ``generic``; group labels:
   ``warp``, ``block``, ``global``) must run the variant their plan picks,
   and every variant that can take a case is forced on it, checked and,
   where the case is timed, timed beside the others (and the group labels
   beside a bare launch);
4. serve: chatglm3-6b, recurrentgemma-2b, falcon-mamba-7b and
   phi-3-vision-4.2b, each at its published widths and full depth in bf16,
   random weights from a seeded CUDA generator, 8 prompts and 32 greedy
   tokens through ``repro_torch.launch.serve.generate`` (recurrentgemma's
   prompt of 4096 tokens is twice its attention window, so the window cuts
   in during prefill and the rolling buffer wraps at the first decode step;
   phi-3-vision's 1024 text tokens follow 1024 image-patch embeddings drawn
   from the same generator); the launch counts of each run are checked
   exactly and its decode logits are held against one full forward;
   recurrentgemma-2b's run then profiles one prefill and one decode step
   (``torch.profiler``: device time by block, by kernel, and inside the
   RG-LRU blocks by op);
5. the same check in fp32 at full width with 2 or 3 layers (phi-3-vision
   with its 1024 image tokens; launch counts exact, every prefill attention
   on the SIMT kernel), and each reduced config's CUDA logits
   (forward and generate) against its plain CPU path (which the CPU tests
   hold against the JAX reference);
6. search: the paper's GA (mobilenet_v3 on simba, preset ``paper``, seed 0)
   and the random backend (resnet50 on eyeriss, 100000 evaluations) through
   ``repro_torch.search.SearchSession`` on the card; each must give the
   reference's genome, fitness and evaluation count exactly (GA_RUNS, held
   equal to the JAX package's by ``tests/test_torch_ga_search.py``), and
   every engine batch must have launched the label kernel once.  One line
   per run in ``BENCH_ga.json``'s record schema.

7. schedule service: the ``island`` backend at BENCH_island.json's cell
   (mobilenet_v3 on simba, seed 0, 60 generations, migrating every 20) at
   1, 2 and 4 islands on the card, islands 2 and 4 in processes started
   with ``spawn`` (this process holds a CUDA context), each held to the
   reference's result exactly (ISLAND_RUNS, held equal to the JAX
   package's by ``tests/test_torch_island.py``) and every island's engine
   to ``cuda`` with one label launch per batch; the same runs with
   ``device="cpu"`` beside them; one line per run in BENCH_island.json's
   record schema plus the device, start method and the seconds from
   starting the islands to the end of their first generation.  Then the
   CLI in subprocesses (``python -m repro_torch``, each search on the
   card): an island search with telemetry and a trace, ``report
   --telemetry`` (certificate, all checks passed), ``serve --workers 2``
   of the README's jobs (an island job twice, deduplicated, and resnet50 on
   eyeriss@act+64), ``submit`` of the first job served from the store with
   no search (its trace holds no search or batch span), ``verify --store``
   and ``trace``; every stored artifact's engine must be ``cuda``.

``--depth-sweep`` runs phases 1-2 and then only falcon-mamba-7b's serve
check at 8, 16, 32 and 64 layers in bf16 and at 64 in fp32, and prints no
contract line.  ``--label-sweep`` runs phases 1-2 and then only phase 3's
label-kernel checks and times on chains of LABEL_SWEEP nodes, to place the
plan's warp/block crossover; no contract line.  ``--decode-sweep`` runs
phases 1-2 and then only both decode kernels, checked and timed over
DECODE_SWEEP_ROWS query rows per kv head and DECODE_SWEEP_SPLITS key splits
at head_dim 96 and 128 over a 2049-key cache, to place the plan's R_MAX and
its split rule; no contract line.  ``--scan-sweep`` runs phases 1-2 and then
only both RG-LRU entries at recurrentgemma-2b's prefill shape over the
ring's tiles (SCAN_SWEEP_*), bf16 and fp32, to place the plan's TILES; no
contract line.

Before the last line: one JSON line ``{"kernels": [...]}`` and the
``nvidia-smi`` name/power-limit line.  Last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import DECODE_IMPLS  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import plan as flash_plan  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ga_labels.ops import ga_labels  # noqa: E402
from repro_torch.kernels.ga_labels.ops import card as ga_card  # noqa: E402
from repro_torch.kernels.ga_labels.ops import plan as ga_plan  # noqa: E402
from repro_torch.kernels.ga_labels.ops import variants as ga_variants  # noqa: E402
from repro_torch.kernels.ga_labels.ref import ga_labels_ref  # noqa: E402
from repro_torch.kernels.ga_labels.ref import label_tables  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import mamba_scan  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import VARIANTS as RGLRU_VARIANTS  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import plan as rglru_plan  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_gated, rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_gated_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_gates_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import plan as rms_plan  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import variants as rms_variants  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.search import SearchSession, SearchSpec  # noqa: E402
from repro_torch.search import build_workload  # noqa: E402

DEV = "cuda"
# tests/test_kernels.py:15 of the reference; its RG-LRU test takes 5x
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RGLRU_TOL_MULT = 5
# flash attention, besides TOL: |out - ref| <= FLASH_ROW_TOL * (RMS of the
# reference's row + |ref|), a row being one query head's D outputs.  TOL's
# absolute part is 2e-2 at any scale, near the whole output of a row that
# averages ~2000 unit-normal keys (RMS ~0.04), where one key dropped moves
# an output by ~1e-3; against the row's own RMS that is several times the
# limit.  bf16 rounds P and the output (2^-9 relative), well inside 2e-2.
FLASH_ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# H100 SXM data sheet (dense): bytes/s of HBM3, flop/s by input type
# (bf16 on the tensor cores, fp32 outside them: TF32 is switched off here)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# serve runs of phase 4: (arch, batch, prompt, new tokens), the prompt in
# text tokens (phi-3-vision-4.2b's come after its 1024 image tokens); the
# kernels' main-path shapes follow from them
SERVES = (("chatglm3-6b", 8, 1024, 32),
          ("recurrentgemma-2b", 8, 4096, 32),
          ("falcon-mamba-7b", 8, 1024, 32),
          ("phi-3-vision-4.2b", 8, 1024, 32))
# decode logits vs one full forward, relative RMS error over all logits.
# bf16: both sides round every product to 8 mantissa bits (2^-9 = 2e-3
# relative per rounding) but at different places (cuBLAS picks other kernels
# for 8 rows than for 8440; the Mamba layers' decode step is plain torch ops
# where the prefill runs the scan kernel), and the differences grow
# with depth, to 0.055 over falcon-mamba-7b's 64 layers: no fixed number
# fits every depth.  So a bf16 run is held against its own rounding floor,
# measured in the same run: the decode logits may be no further from the
# fp32 forward of the same weights than FLOOR_MULT times the bf16 forward
# is.  The two distances agree within 1% on all three models (they differ
# only in where bf16 rounds); a wrong cache slot, key position, recurrent
# state or conv history adds an error of order 1 and fails.
FLOOR_MULT = 1.1
# phase 5's prompts in text tokens (phi-3-vision's after its 1024 image
# tokens)
FP32_PROMPT = 128
# fp32 (TF32 off): sums in another order only (~1e-6); bf16 arithmetic or
# TF32 would give >= 1e-3 and fail it.
SERVE_REL_TOL_FP32 = 1e-4
# the kernels' launch counters; the residual RMSNorm form is counted apart
COUNTERS = {"rmsnorm": fused_rmsnorm, "flash_attention": flash_attention,
            "rglru_scan": rglru_scan, "rglru_gated": rglru_gated,
            "mamba_scan": mamba_scan, "ga_labels": ga_labels}
KERNELS = ("rmsnorm", "rmsnorm_residual", "flash_attention", "rglru_scan",
           "rglru_gated", "mamba_scan", "ga_labels")
# phase 6: the search runs and the reference's results for them (the JAX
# package's ``repro.search.search`` with the same arguments; pinned equal
# to it by tests/test_torch_ga_search.py)
GA_RUNS = {
    "paper_ga": dict(
        spec=dict(workload="mobilenet_v3", accelerator="simba", backend="ga",
                  backend_config={"preset": "paper"}, seed=0),
        golden=dict(genome_mask=0x15a4a934ac4f175acdd2749a5cdf,
                    best_fitness=1.5828072147849952, evaluations=59705)),
    "random": dict(
        spec=dict(workload="resnet50", accelerator="eyeriss",
                  backend="random", backend_config={"evaluations": 100000},
                  seed=0),
        golden=dict(genome_mask=0x21000000010051082,
                    best_fitness=1.0263130846327753, evaluations=99998)),
}
# phase 7: the island backend at BENCH_island.json's cell (mobilenet_v3 on
# simba, seed 0, 60 generations of the paper preset, migrating every 20) and
# the reference's results for it (``repro.search.search(..., backend=
# "island")``; pinned equal to it by tests/test_torch_island.py)
ISLAND_SPEC = dict(workload="mobilenet_v3", accelerator="simba",
                   backend="island", seed=0)
ISLAND_RUNS = {
    1: dict(genome_mask=0x15a46930ac4e973acd9274945cdf,
            best_fitness=1.5826680686747943, history_len=60,
            evaluations=10350, offspring_evaluated=10800),
    2: dict(genome_mask=0x15a4a934aa4f173acd8264905cdf,
            best_fitness=1.5824383590058961, history_len=60,
            evaluations=20579, offspring_evaluated=21600),
    4: dict(genome_mask=0x15a4a934ac4f173acde2749c5ccf,
            best_fitness=1.5827601514969192, history_len=60,
            evaluations=41126, offspring_evaluated=43200),
}


def island_config(islands: int) -> dict:
    return {"generations": 60, "islands": islands, "migrate_every": 20}


# phase 3's label-kernel check: genomes per graph and fused-bit densities
GA_ROWS = 65536
GA_LONG_ROWS = 4096        # the graph too long for shared memory
GA_DENSITIES = (0.5, 0.1)
# the engine's batch sizes (phase 6): ~63 new genomes a batch in the paper
# GA, 128 in the random search
GA_BATCHES = (("mobilenet_v3", 64), ("resnet50", 128))
# --label-sweep's chain lengths: 906 to 2772 words a row
LABEL_SWEEP = (340, 450, 560, 680, 800, 920, 1040)
# --decode-sweep: query rows per kv head (G at Sq 1) and warp_decode's key
# splits, over phi-3-vision's decode cache (32 kv heads, 2049 of 2080
# slots) at batch 8 (256 blocks before splitting) and, at 1 and 8 rows, at
# batch 2 (64)
DECODE_SWEEP_ROWS = (1, 2, 4, 5, 6, 7, 8, 10, 16)
DECODE_SWEEP_SPLITS = (1, 2, 3, 4)
DECODE_SWEEP_SMALL = (1, 8)
# --scan-sweep: the RG-LRU ring's tiles at recurrentgemma-2b's prefill
# shape, both entries, both dtypes: channels a block, steps a tile, stages
# a block, steps a thread, threads a channel (a tile is their product)
SCAN_SWEEP_CHANNELS = (32, 64)
SCAN_SWEEP_STEPS = (8, 16)
SCAN_SWEEP_SPLITS = (1, 2, 4, 8)
SCAN_SWEEP_STAGES = (2, 3, 4)


def log(*a) -> None:
    print(*a, flush=True)


def row_scaled_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (RMS of ref over the last dim + |ref|)."""
    out, ref = out.float(), ref.float()
    scale = ref.square().mean(-1, keepdim=True).sqrt() + ref.abs()
    return ((out - ref).abs() / scale).nan_to_num(0.0, torch.inf).max().item()


def close(out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Max abs error; raises unless |out - ref| <= tol + tol * |ref|."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"shape {tuple(out.shape)} vs {tuple(ref.shape)}"
                             f" or non-finite output")
    err = (out - ref).abs()
    if not bool((err <= tol + tol * ref.abs()).all()):
        raise AssertionError(f"max abs error {err.max().item():.3e} beyond "
                             f"tolerance {tol:g} (abs + rel)")
    return err.max().item()


class Timer:
    """Median device time of one call, CUDA events around it.  Before each
    call the 50 MB L2 is flushed (a 256 MB write) and the stream is held by a
    sleep kernel, so host-side launch work is not counted."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def ms(self, fn, reps: int = 10) -> float:
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)          # ~1 ms of GPU clock
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            times.append(self.start.elapsed_time(self.end))
        return statistics.median(times)


def esize(dt: torch.dtype) -> int:
    return torch.tensor([], dtype=dt).element_size()


def bound(nbytes: int, flops: int, dt: torch.dtype) -> dict:
    """The least time of the work: the larger of its bytes over the memory
    rate and its operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dt]
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rmsnorm_work(n: int, d: int, dt: torch.dtype, residual: bool) -> dict:
    es = esize(dt)
    rows = 4 if residual else 2             # x (+ r) read, y (+ x + r) written
    return bound(rows * n * d * es + d * es, (5 if residual else 4) * n * d,
                 torch.float32)


def rolling_kpos(pos: int, L: int) -> torch.Tensor:
    """Key positions of a rolling buffer of L slots after position ``pos``
    was written (position p in slot p % L; -1: unwritten)."""
    s = torch.arange(L)
    p = pos - (pos - s) % L
    return torch.where(p >= 0, p, -1).to(torch.int32)


def flash_work(B, Sq, Skv, Hq, Hkv, D, dt, causal=True, window=0, chunk=0,
               q_offset=0, kv_len=None, k_pos=None) -> dict:
    """q, o and the keys any query can see, once each; 4*D flops per
    unmasked (query, key) pair."""
    kv_len = Skv if kv_len is None else kv_len
    qp = q_offset + torch.arange(Sq)[:, None]
    slot = torch.arange(Skv)[None, :]
    kp = slot if k_pos is None else k_pos.cpu().long()[None, :]
    ok = (slot < kv_len) & (kp >= 0) & (qp >= 0)   # (Sq, Skv)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    if chunk:
        ok &= kp // chunk == qp // chunk
    keys_needed = int(ok.any(0).sum())
    nbytes = (2 * B * Sq * Hq * D + 2 * B * keys_needed * Hkv * D) * esize(dt)
    return bound(nbytes, 4 * D * B * Hq * int(ok.sum()), dt)


def sdpa_call(q, k, v, causal, window, q_offset, kv_len, k_pos):
    """One ``scaled_dot_product_attention`` call computing what the flash
    kernel computes (the mask built beforehand, not timed)."""
    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not window and k_pos is None:          # a prefix of the keys
        n = Skv if kv_len is None else kv_len
        kt, vt = kt[:, :, :n], vt[:, :, :n]
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal and Sq > 1, enable_gqa=True)
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    slot = torch.arange(Skv, device=q.device)[None, :]
    kp = slot if k_pos is None else k_pos.long()[None, :]
    mask = (slot < (Skv if kv_len is None else kv_len)) & (kp >= 0) \
        & (qp >= 0)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    secs = _build.build_all()
    log(f"[build] {', '.join(_build.sources())} built in {secs:.1f} s")


def phase_sass() -> None:
    """The tensor-core prefill's two products are wgmma in the built code
    (``cuobjdump -sass``): Q.K^T as HGMMA 64x64x16 from shared memory, P.V
    as HGMMA 64xDx16 with P in registers and V transposed (``tnspB``) at
    each head_dim, fed by TMA loads (UTMALDG)."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build._lib_path("flash_prefill_tc"))],
        capture_output=True, text=True, check=True).stdout
    hgmma = [line for line in sass.splitlines() if "HGMMA." in line]
    qk = sum("HGMMA.64x64x16" in x and "tnspB" not in x for x in hgmma)
    pv = {d: sum(f"HGMMA.64x{d}x16" in x and "tnspB" in x for x in hgmma)
          for d in (64, 96, 128, 256)}
    tma = sass.count("UTMALDG")
    log(f"[sass] flash_prefill_tc: Q.K^T {qk} HGMMA 64x64x16; P.V by "
        f"head_dim {pv} HGMMA 64xDx16 (tnspB); {tma} UTMALDG")
    if not qk or not all(pv.values()) or not tma:
        raise AssertionError("flash_prefill_tc: a product is not wgmma or "
                             "the loads are not TMA")


def ran_variant(fn, before: dict) -> str:
    """The variant whose launch count moved since ``before``."""
    return next(v for v, c in fn.variant_launches.items() if c > before[v])


def kernels_rmsnorm(timer: Timer, rn) -> dict:
    """Both forms, both dtypes; serve shapes (the prefill rows, batch x
    (image + text positions), and the decode rows, batch, of each SERVES
    model at its d_model: 4096, 2560 and 3072) + a ragged one.  Each case
    runs the variant ``plan`` picks (``vector`` at the serve shapes); every
    variant that takes it is forced and checked.  Timed in bf16 at the serve
    shapes, every variant (``ms``: the plan's), beside a device copy of the
    same bytes."""
    shapes = []
    for arch, batch, prompt, _ in SERVES:
        cfg = get_config(arch)
        for n in (batch * (cfg.img_tokens + prompt), batch):
            if (n, cfg.d_model, True) not in shapes:
                shapes.append((n, cfg.d_model, True))
    shapes.append((37, 130, False))
    plain, resid = [], []
    for dt in (torch.float32, torch.bfloat16):
        for n, dd, serve in shapes:
            x, r = rn(n, dd, dt=dt), rn(n, dd, dt=dt)
            w = (rn(dd, dt=torch.float32) * 0.1 + 1.0).to(dt)
            how = rms_plan(dd, dt)
            want = how.variant
            before = dict(fused_rmsnorm.variant_launches)
            y0 = fused_rmsnorm(x, w)
            ran = ran_variant(fused_rmsnorm, before)
            if ran != want or (serve and ran != "vector"):
                raise AssertionError(f"rmsnorm {n}x{dd} {dt}: ran {ran}, "
                                     f"planned {want}")
            variants = rms_variants(dd, dt)
            yr, resr = rmsnorm_ref(x, w, r)
            base = {"shape": [n, dd], "dtype": str(dt)[6:], "tol": TOL[dt],
                    "variant": want, "threads": how.threads,
                    "vectors": how.vectors}
            err, err_r = {}, {}
            for v in variants:
                err[v] = close(fused_rmsnorm(x, w, variant=v),
                               rmsnorm_ref(x, w), TOL[dt])
                y, res = fused_rmsnorm(x, w, r, variant=v)
                err_r[v] = max(close(y, yr, TOL[dt]),
                               close(res, resr, TOL[dt]))
            close(y0, rmsnorm_ref(x, w), TOL[dt])
            case = dict(base, max_abs_err=max(err[v] for v in variants),
                        err_by_variant={v: err[v] for v in variants})
            case_r = dict(base, max_abs_err=max(err_r[v] for v in variants),
                          err_by_variant={v: err_r[v] for v in variants})
            if dt == torch.bfloat16 and serve:
                t = {v: timer.ms(lambda: fused_rmsnorm(x, w, variant=v))
                     for v in variants}
                t_r = {v: timer.ms(lambda: fused_rmsnorm(x, w, r, variant=v))
                       for v in variants}
                # a device copy moves the plain form's bytes (x read, y
                # written) and nothing else: the practical floor here
                yc = torch.empty_like(x)
                case.update(
                    ms=t[want], ms_by_variant=t,
                    copy_ms=timer.ms(lambda: yc.copy_(x)),
                    plain_ms=timer.ms(lambda: rmsnorm_ref(x, w)),
                    library_ms=timer.ms(
                        lambda: F.rms_norm(x, (dd,), w, eps=1e-6)),
                    **rmsnorm_work(n, dd, dt, residual=False))
                # no single PyTorch call adds and normalises
                case_r.update(
                    ms=t_r[want], ms_by_variant=t_r,
                    plain_ms=timer.ms(lambda: rmsnorm_ref(x, w, r)),
                    library_ms=None, **rmsnorm_work(n, dd, dt, residual=True))
            log(f"[kernels] rmsnorm {case}")
            log(f"[kernels] rmsnorm_residual {case_r}")
            plain.append(case)
            resid.append(case_r)
            del x, r, w, y0, yr, resr
    return {"rmsnorm": plain, "rmsnorm_residual": resid}


def flash_cases() -> list:
    """Phase 3's flash-attention cases: (name, (B, Sq, Skv, Hq, Hkv, D),
    keyword arguments), key positions as CPU tensors.  Serve prefill/decode
    of chatglm3-6b (D 128, causal, GQA 16:1) and of recurrentgemma-2b (D
    256, window 2048, MQA 10:1; decode over the 4096-slot rolling buffer,
    wrapped, with key positions), then small ragged/masked ones that reach
    each kernel of the plan (``ops.plan``): the tensor-core prefill at D 64,
    128 and 256 with ragged S, window, chunk, bidirectional and G 1, 10 and
    16; the split decode with splits of several tiles and kv_len not a
    multiple of them, several queries, two row groups, a partly written
    rolling buffer; the SIMT kernel (fp32, D 16/32, key positions in
    prefill).  Then head_dim 96: phi-3-vision-4.2b's serve prefill (1024
    image + 1024 text positions, MHA 32:32) and first decode step (2049 of
    2080 slots), ragged cases reaching each kernel at D 96, G 1 among them,
    and phase 5's fp32 prefill (1024 image + 128 text positions).  Last,
    decode cases for the warp kernel: G 1 at each head_dim, a wrapped
    rolling buffer with key positions, window, chunk, 2 and 8 queries, B 1
    with a long cache (many splits), a grid large enough for one split,
    and G 8 and 9 (R_MAX and R_MAX + 1 rows a kv head)."""
    cfg = get_config("chatglm3-6b")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    _, B, P, N = SERVES[0]
    pos = P + 16
    rg = get_config("recurrentgemma-2b")
    _, B_rg, P_rg, N_rg = SERVES[1]
    W = rg.attn_window
    L = min(2 * W, P_rg + N_rg)               # the rolling buffer: 4096 slots
    pos_rg = P_rg + 16                        # mid-decode: the buffer wrapped
    arch_v, B_v, P_v, N_v = SERVES[3]
    phi = get_config(arch_v)
    heads_v = (phi.n_heads, phi.n_kv_heads, phi.resolved_head_dim)
    S_v = phi.img_tokens + P_v                # prefill positions: 2048
    S_fp32 = phi.img_tokens + FP32_PROMPT
    return [
        ("prefill", (B, P, P, hq, hkv, hd), {}),
        ("decode", (B, 1, P + N, hq, hkv, hd),
         dict(q_offset=pos, kv_len=pos + 1)),
        ("decode_whole_buffer", (B, 1, P + N, hq, hkv, hd),
         dict(q_offset=pos)),
        ("prefill_d256_window", (B_rg, P_rg, P_rg, rg.n_heads,
                                 rg.n_kv_heads, rg.head_dim),
         dict(window=W)),
        ("decode_d256_rolling", (B_rg, 1, L, rg.n_heads, rg.n_kv_heads,
                                 rg.head_dim),
         dict(q_offset=pos_rg, kv_len=L, window=W,
              k_pos=rolling_kpos(pos_rg, L))),
        ("mqa_ragged", (1, 33, 33, 8, 1, 16), {}),
        ("gqa_ragged", (2, 80, 80, 4, 2, 32), {}),
        ("window", (2, 96, 96, 4, 2, 32), dict(window=16)),
        ("chunk", (2, 96, 96, 4, 2, 32), dict(chunk=32)),
        ("bidir", (2, 96, 96, 4, 2, 32), dict(causal=False)),
        ("decode_d32", (2, 1, 64, 4, 2, 32), dict(q_offset=40, kv_len=41)),
        ("d256_ragged_window", (2, 70, 70, 4, 1, 256), dict(window=16)),
        # a 16-slot buffer, window 8, after position 21; then a partly
        # written one (slots 6.. unwritten: -1) read in full
        ("kpos_wrapped", (2, 1, 16, 4, 1, 32),
         dict(q_offset=21, window=8, k_pos=rolling_kpos(21, 16))),
        ("kpos_partial_d256", (2, 1, 16, 4, 1, 256),
         dict(q_offset=5, window=8, k_pos=rolling_kpos(5, 16))),
        ("tc_d64_g1_ragged", (1, 200, 200, 2, 2, 64), {}),
        ("tc_d64_bidir", (2, 1000, 1000, 4, 2, 64), dict(causal=False)),
        ("tc_d128_g16_ragged", (2, 1000, 1000, 16, 1, 128), {}),
        ("tc_d128_chunk", (2, 200, 200, 4, 2, 128), dict(chunk=64)),
        ("tc_d128_offset", (1, 100, 300, 4, 2, 128),
         dict(q_offset=200, kv_len=300)),
        # window across both warpgroups; 130 rows: the last block's second
        # warpgroup has none (its Q box wholly out of bounds)
        ("tc_d128_window_130", (1, 130, 130, 4, 2, 128), dict(window=50)),
        ("tc_d256_g10_window", (1, 200, 200, 10, 1, 256), dict(window=64)),
        ("tc_d256_g10_ragged", (1, 1000, 1000, 10, 1, 256),
         dict(window=300)),
        ("tc_d256_bidir", (1, 200, 200, 10, 1, 256), dict(causal=False)),
        # 3-tile splits over 997 of 1000 slots; 4 and 8 queries (two row
        # groups of 16); chunks; a rolling buffer written up to 1000
        ("decode_ragged_splits", (8, 1, 1000, 64, 8, 128),
         dict(q_offset=996, kv_len=997)),
        ("decode_sq4", (2, 4, 300, 8, 2, 64), dict(q_offset=296, kv_len=300)),
        ("decode_sq8_row_groups", (1, 8, 256, 8, 2, 32), dict(q_offset=248)),
        ("decode_chunk_d16", (2, 3, 200, 4, 1, 16),
         dict(q_offset=150, kv_len=153, chunk=64)),
        ("decode_bidir", (2, 1, 130, 4, 2, 64), dict(causal=False)),
        ("decode_rolling_partial", (2, 1, L, rg.n_heads, rg.n_kv_heads,
                                    rg.head_dim),
         dict(q_offset=1000, kv_len=L, window=W,
              k_pos=rolling_kpos(1000, L))),
        ("kpos_prefill", (1, 24, 24, 4, 2, 64),
         dict(window=8, k_pos=torch.arange(24, dtype=torch.int32))),
        # phase 5's fp32 prefill shapes (8 x 128 prompts), where the SIMT
        # kernel runs on a model path
        ("prefill_s128", (8, 128, 128, hq, hkv, hd), {}),
        ("prefill_d256_s128_window", (8, 128, 128, rg.n_heads,
                                      rg.n_kv_heads, rg.head_dim),
         dict(window=W)),
        ("prefill_d96", (B_v, S_v, S_v) + heads_v, {}),
        ("decode_d96", (B_v, 1, S_v + N_v) + heads_v,
         dict(q_offset=S_v, kv_len=S_v + 1)),
        ("tc_d96_g1_ragged", (1, 200, 200, 2, 2, 96), {}),
        ("tc_d96_window_130", (2, 130, 130, 4, 2, 96), dict(window=50)),
        ("tc_d96_chunk", (2, 200, 200, 4, 1, 96), dict(chunk=64)),
        ("tc_d96_bidir", (2, 300, 300, 4, 4, 96), dict(causal=False)),
        ("tc_d96_offset", (1, 100, 300, 4, 2, 96),
         dict(q_offset=200, kv_len=300)),
        ("decode_d96_g1_ragged_splits", (2, 1, 1000, 4, 4, 96),
         dict(q_offset=996, kv_len=997)),
        ("decode_d96_sq4", (2, 4, 300, 8, 2, 96),
         dict(q_offset=296, kv_len=300)),
        ("kpos_wrapped_d96", (2, 1, 16, 4, 1, 96),
         dict(q_offset=21, window=8, k_pos=rolling_kpos(21, 16))),
        ("kpos_prefill_d96", (1, 24, 24, 4, 2, 96),
         dict(window=8, k_pos=torch.arange(24, dtype=torch.int32))),
        ("prefill_d96_s1152", (8, S_fp32, S_fp32) + heads_v, {}),
        ("warp_d16_g1", (2, 1, 300, 4, 4, 16), dict(q_offset=299)),
        ("warp_d32_g1_kv_len", (2, 1, 300, 4, 4, 32),
         dict(q_offset=250, kv_len=251)),
        ("warp_d64_g1_window", (2, 1, 700, 4, 4, 64),
         dict(q_offset=699, window=100)),
        ("warp_d128_g1_chunk", (2, 1, 500, 4, 4, 128),
         dict(q_offset=450, kv_len=451, chunk=128)),
        ("warp_d256_g1", (2, 1, 300, 2, 2, 256), dict(q_offset=299)),
        ("warp_d96_g1_kpos_wrapped", (2, 1, 512, 4, 4, 96),
         dict(q_offset=1300, window=300, k_pos=rolling_kpos(1300, 512))),
        ("warp_d96_sq2_g4", (2, 2, 300, 8, 2, 96),
         dict(q_offset=298, kv_len=300)),
        ("warp_d96_sq8_g1_chunk", (1, 8, 400, 4, 4, 96),
         dict(q_offset=392, chunk=128)),
        ("warp_d128_b1_long", (1, 1, 4000, 4, 4, 128),
         dict(q_offset=3990, kv_len=3991)),
        ("warp_d64_one_split", (8, 1, 200, 32, 32, 64),
         dict(q_offset=150, kv_len=151)),
        ("warp_d128_g8", (2, 1, 500, 16, 2, 128), dict(q_offset=499)),
        ("warp_d128_g9", (2, 1, 500, 18, 2, 128), dict(q_offset=499)),
    ]


# the timed cases, each with the kernel it must run: the bf16 serve shapes
# and, in fp32, phase 5's prefills on the SIMT kernel
FLASH_TIMED = {torch.bfloat16: {"prefill": "tc_prefill",
                                "decode": "split_decode",
                                "prefill_d256_window": "tc_prefill",
                                "decode_d256_rolling": "split_decode",
                                "prefill_d96": "tc_prefill",
                                "decode_d96": "warp_decode"},
               torch.float32: {"prefill_s128": "simt",
                               "prefill_d256_s128_window": "simt",
                               "prefill_d96_s1152": "simt"}}


def flash_check(name: str, out, ref, dt) -> tuple:
    """(max abs error, row-scaled error); raises beyond TOL or
    FLASH_ROW_TOL."""
    err = close(out, ref, TOL[dt])
    row_err = row_scaled_err(out, ref)
    if not row_err <= FLASH_ROW_TOL[dt]:
        raise AssertionError(f"flash {name} {dt}: error {row_err:.3e} of "
                             f"the rows' scale > {FLASH_ROW_TOL[dt]:g}")
    return err, row_err


def kernels_flash(timer: Timer, rn) -> list:
    """Each case of ``flash_cases`` in bf16 and fp32 against the plain
    version, within TOL and FLASH_ROW_TOL, with the kernel it ran (``impl``:
    the plan's, and at the timed shapes the one named in FLASH_TIMED); a
    case of at most 8 query rows also runs the other decode kernel, forced
    (its own entry, ``forced``: true).  Timed at the FLASH_TIMED shapes
    (bf16 first: its prefill is the kernel line's headline), and at
    phi-3-vision's decode the forced split kernel beside the warp kernel,
    in turns.  At each timed decode the plain version without the newest
    key must fail FLASH_ROW_TOL, or the check could not see a kernel that
    skips it."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for name, (Bq, Sq, Skv, Hq, Hkv, D), kw in flash_cases():
            kw = dict(kw)
            if "k_pos" in kw:
                kw["k_pos"] = kw["k_pos"].to(DEV)
            q, k, v = rn(Bq, Sq, Hq, D, dt=dt), rn(Bq, Skv, Hkv, D, dt=dt), \
                rn(Bq, Skv, Hkv, D, dt=dt)
            before = dict(flash_attention.impl_launches)
            out = flash_attention(q, k, v, **kw)
            impl = next(i for i, n in flash_attention.impl_launches.items()
                        if n > before[i])
            kv_len = kw.get("kv_len", Skv)
            how = flash_plan(Bq, Sq, Hq, Hkv, D, dt, kv_len, "k_pos" in kw)
            serve = name in FLASH_TIMED[dt]
            if impl != how.impl or (serve and impl != FLASH_TIMED[dt][name]):
                raise AssertionError(f"flash {name}: ran {impl}, planned "
                                     f"{how.impl}")
            ref = attention_ref(q, k, v, **kw)
            err, row_err = flash_check(name, out, ref, dt)
            case = {"case": name, "shape": [Bq, Sq, Skv, Hq, Hkv, D],
                    **{a: b for a, b in kw.items() if a != "k_pos"},
                    "k_pos": "k_pos" in kw, "dtype": str(dt)[6:],
                    "impl": impl, "tol": TOL[dt], "max_abs_err": err,
                    "row_tol": FLASH_ROW_TOL[dt], "row_scaled_err": row_err}
            other = None
            if how.impl in DECODE_IMPLS:
                case.update(splits=how.splits,
                            tiles_per_split=how.tiles_per_split,
                            blocks=how.blocks)
                alt = next(i for i in DECODE_IMPLS if i != how.impl)
                forced = flash_plan(Bq, Sq, Hq, Hkv, D, dt, kv_len,
                                    "k_pos" in kw, alt)
                err_f, row_f = flash_check(
                    f"{name} ({alt} forced)",
                    flash_attention(q, k, v, impl=alt, **kw), ref, dt)
                other = dict(case, impl=alt, forced=True, max_abs_err=err_f,
                             row_scaled_err=row_f, splits=forced.splits,
                             tiles_per_split=forced.tiles_per_split,
                             blocks=forced.blocks)
            if serve and Sq == 1:
                short = dict(kw, kv_len=kw.get("kv_len", Skv) - 1)
                miss = row_scaled_err(attention_ref(q, k, v, **short), ref)
                if not miss > FLASH_ROW_TOL[dt]:
                    raise AssertionError(f"flash {name}: dropping the newest "
                                         f"key moves the output {miss:.3e} "
                                         f"of the rows' scale, within the "
                                         f"tolerance")
                case["newest_key_dropped_row_scaled_err"] = miss
            if serve:
                lib = sdpa_call(q, k, v, True, kw.get("window", 0),
                                kw.get("q_offset", 0), kw.get("kv_len"),
                                kw.get("k_pos"))
                case.update(
                    ms=timer.ms(lambda: flash_attention(q, k, v, **kw)),
                    plain_ms=timer.ms(lambda: attention_ref(q, k, v, **kw),
                                      reps=5),
                    library_ms=timer.ms(lib),
                    **flash_work(Bq, Sq, Skv, Hq, Hkv, D, dt, **kw))
                if how.impl == "warp_decode":
                    # the split kernel beside it, in turns: warp (above),
                    # split, split, warp
                    alt = other["impl"]
                    t_alt = [timer.ms(lambda: flash_attention(
                        q, k, v, impl=alt, **kw)) for _ in range(2)]
                    t_own = [case["ms"], timer.ms(
                        lambda: flash_attention(q, k, v, **kw))]
                    case.update(ms=statistics.mean(t_own), ms_runs=t_own)
                    other.update(
                        {a: case[a] for a in ("plain_ms", "library_ms",
                                              "bytes", "flops", "bound_ms",
                                              "bound_by")},
                        ms=statistics.mean(t_alt), ms_runs=t_alt)
            log(f"[kernels] flash_attention {case}")
            cases.append(case)
            if other is not None:
                log(f"[kernels] flash_attention {other}")
                cases.append(other)
            del q, k, v, out, ref
    return cases


def rglru_shapes() -> tuple:
    """(B, S, W, serve): recurrentgemma-2b's prefill shape (B 8, S 4096, W
    2560), then the reference test's shapes, ragged ones included (W 20 and
    129 give rows that 16-byte copies do not divide)."""
    rg = get_config("recurrentgemma-2b")
    _, B, P, _ = SERVES[1]
    return ((B, P, rg.rnn_width, True), (1, 32, 16, False),
            (2, 50, 20, False), (1, 9, 129, False), (3, 7, 129, False))


def in_turns(timer: Timer, fns: dict) -> dict:
    """Each callable's time, taken in turns (a, b, b, a): name -> the mean
    of its two times."""
    times = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        times[n].append(timer.ms(fns[n]))
    return {n: statistics.mean(t) for n, t in times.items()}


def rglru_scan_inputs(g, Bs, S, Wd, dt) -> tuple:
    a = (torch.rand(Bs, S, Wd, generator=g, device=DEV) * 0.49 + 0.5).to(dt)
    b = torch.randn(Bs, S, Wd, generator=g, device=DEV).to(dt)
    return a, b


def rglru_gated_inputs(g, Bs, S, Wd, dt) -> tuple:
    """xa, xi, xc unit normal in ``dt`` (xc @ w_a at the model's init scale
    is about unit normal); b_a, b_i normal * 0.5; lambda as the model draws
    it (a^8 uniform in [0.9, 0.999], so a runs up to ~1 and 1 - a^2 is
    small); h0 unit normal."""
    xa, xi, xc = (torch.randn(Bs, S, Wd, generator=g, device=DEV).to(dt)
                  for _ in range(3))
    b_a, b_i = (torch.randn(Wd, generator=g, device=DEV) * 0.5
                for _ in range(2))
    u = torch.rand(Wd, generator=g, device=DEV) * 0.099 + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    h0 = torch.randn(Bs, Wd, generator=g, device=DEV)
    return (xa, xi, xc, b_a, b_i, lam), h0


def rglru_today(xa, xi, xc, b_a, b_i, lam, h0=None):
    """The model's RG-LRU path before the gated kernel: the gate arithmetic
    as eager fp32 ops, then the ``simple`` scan kernel (prefill) or the
    elementwise step on h0 (decode), then the cast of h."""
    a, b = rglru_gates_ref(xa, xi, xc, b_a, b_i, lam)
    if xc.shape[1] == 1:
        h_last = a[:, 0] * (torch.zeros_like(a[:, 0]) if h0 is None
                            else h0) + b[:, 0]
        hs = h_last[:, None]
    else:
        hs = rglru_scan(a, b, variant="simple")
        h_last = hs[:, -1].clone()
    return hs.to(xc.dtype), h_last


def rglru_gated_work(Bs, S, Wd, dt, h0: bool) -> dict:
    """xa, xi, xc read and h written once each, b_a, b_i, lambda (and h0)
    read and h_last written; ~30 fp32 operations an element (two sigmoids,
    an exp, a square root, the products and the multiply-add)."""
    n = Bs * S * Wd
    nbytes = 4 * n * esize(dt) + 3 * Wd * 4 + (2 if h0 else 1) * Bs * Wd * 4
    return bound(nbytes, 30 * n, torch.float32)


def plan_fields(how) -> dict:
    return {k: getattr(how, k) for k in ("variant", "channels", "steps",
                                         "split", "stages", "threads",
                                         "copy_bytes", "blocks")}


def kernels_rglru(timer: Timer, g) -> list:
    """The interface entry (a, b -> h) at ``rglru_shapes``, fp32 and bf16:
    the plan's variant must be the one that runs, and every variant is
    forced and held to TOL x RGLRU_TOL_MULT of ``rglru_scan_ref``; at the
    serve shape each variant is timed, in turns, and the plan's must be the
    faster."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for Bs, S, Wd, serve in rglru_shapes():
            a, b = rglru_scan_inputs(g, Bs, S, Wd, dt)
            tol = TOL[dt] * RGLRU_TOL_MULT
            before = dict(rglru_scan.variant_launches)
            h = rglru_scan(a, b)
            ran = ran_variant(rglru_scan, before)
            how = rglru_plan(Bs, S, Wd, dt)
            ref = rglru_scan_ref(a, b)
            err = {v: close(rglru_scan(a, b, variant=v), ref, tol)
                   for v in RGLRU_VARIANTS}
            close(h, ref, tol)
            if ran != how.variant:
                raise AssertionError(f"rglru_scan {Bs}x{S}x{Wd} {dt}: ran "
                                     f"{ran}, planned {how.variant}")
            case = {"entry": "interface", "shape": [Bs, S, Wd],
                    "dtype": str(dt)[6:], "tol": tol, **plan_fields(how),
                    "max_abs_err": max(err.values()), "err_by_variant": err}
            if serve:
                t = in_turns(timer, {
                    v: (lambda v=v: rglru_scan(a, b, variant=v))
                    for v in RGLRU_VARIANTS})
                case.update(
                    ms=t[ran], ms_by_variant=t,
                    plain_ms=timer.ms(lambda: rglru_scan_ref(a, b), reps=3),
                    # no single PyTorch call computes a linear recurrence
                    library_ms=None,
                    **bound(3 * a.numel() * esize(dt), 2 * a.numel(),
                            torch.float32))
                if min(t, key=t.get) != ran:
                    raise AssertionError(f"rglru_scan {dt}: the plan's {ran} "
                                         f"is not the faster variant: {t}")
            log(f"[kernels] rglru_scan {case}")
            cases.append(case)
            del a, b, h, ref
    return cases


def kernels_rglru_gated(timer: Timer, g) -> list:
    """The gated entry against ``rglru_gated_ref`` on the card, h within TOL
    x RGLRU_TOL_MULT of its dtype and h_last (fp32 arithmetic on the same
    inputs) within the fp32 one: recurrentgemma-2b's prefill shape in bf16
    (the model's) and fp32, from zero and from h0; its decode shape (8, 1,
    2560) from h0 and from zero; the ragged shapes.  Timed at the prefill
    (from zero) and decode (from h0) shapes beside the bound, the plain
    version and today's layer path (``rglru_today``)."""
    rg = get_config("recurrentgemma-2b")
    _, B, _, _ = SERVES[1]
    shapes = [(Bs, S, Wd, serve) for Bs, S, Wd, serve in rglru_shapes()]
    shapes.insert(1, (B, 1, rg.rnn_width, True))
    shapes.append((2, 1, 129, False))
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for Bs, S, Wd, serve in shapes:
            args, h0 = rglru_gated_inputs(g, Bs, S, Wd, dt)
            tol = TOL[dt] * RGLRU_TOL_MULT
            tol_last = TOL[torch.float32] * RGLRU_TOL_MULT
            how = rglru_plan(Bs, S, Wd, dt, gated=True)
            for start in (None, h0):
                h, h_last = rglru_gated(*args, start)
                hr, hr_last = rglru_gated_ref(*args, start)
                case = {"entry": "gated", "shape": [Bs, S, Wd],
                        "dtype": str(dt)[6:], "h0": start is not None,
                        "tol": tol, "h_last_tol": tol_last,
                        **plan_fields(how),
                        "max_abs_err": close(h, hr, tol),
                        "h_last_max_abs_err": close(h_last, hr_last,
                                                    tol_last)}
                del h, h_last, hr, hr_last
                # timed: the prefill from zero, the decode step from h0
                if serve and (start is None) == (S > 1):
                    t = in_turns(timer, {
                        "gated": lambda: rglru_gated(*args, start),
                        "today": lambda: rglru_today(*args, start)})
                    case.update(
                        ms=t["gated"], today_ms=t["today"],
                        plain_ms=timer.ms(
                            lambda: rglru_gated_ref(*args, start), reps=3),
                        library_ms=None,
                        **rglru_gated_work(Bs, S, Wd, dt, start is not None))
                log(f"[kernels] rglru_gated {case}")
                cases.append(case)
            del args, h0
    return cases


def kernels_mamba(timer: Timer, g) -> list:
    """falcon-mamba-7b's prefill shape (B 8, S 1024, Di 8192, N 16; fp32 on
    the model path) + the reference test's shapes and ragged ones, each N
    of {4, 8, 16}; the final state is checked too."""
    fm = get_config("falcon-mamba-7b")
    _, B, P, _ = SERVES[2]
    shapes = ((B, P, fm.d_inner, fm.ssm_state, True), (1, 32, 16, 4, False),
              (2, 40, 24, 8, False), (1, 7, 130, 16, False),
              (2, 9, 130, 4, False), (1, 50, 130, 8, False))
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for Bs, S, Di, N, serve in shapes:
            da = (torch.rand(Bs, S, Di, N, generator=g, device=DEV) * 0.49
                  + 0.5).to(dt)
            dbx = (torch.randn(Bs, S, Di, N, generator=g, device=DEV)
                   * 0.1).to(dt)
            c = torch.randn(Bs, S, N, generator=g, device=DEV).to(dt)
            y, h_last = mamba_scan(da, dbx, c)
            yr, hr = mamba_scan_ref(da, dbx, c)
            case = {"shape": [Bs, S, Di, N], "dtype": str(dt)[6:],
                    "tol": TOL[dt], "max_abs_err": close(y, yr, TOL[dt]),
                    "h_last_max_abs_err": close(h_last, hr, TOL[dt])}
            del y, h_last, yr, hr
            if serve:
                es = esize(dt)
                nbytes = ((2 * da.numel() + c.numel() + Bs * S * Di) * es
                          + Bs * Di * N * 4)
                case.update(
                    ms=timer.ms(lambda: mamba_scan(da, dbx, c)),
                    plain_ms=timer.ms(lambda: mamba_scan_ref(da, dbx, c),
                                      reps=3),
                    library_ms=None,
                    **bound(nbytes, 4 * da.numel(), torch.float32))
            log(f"[kernels] mamba_scan {case}")
            cases.append(case)
            del da, dbx, c
    return cases


def chain_with_skips(n: int, seed: int) -> tuple:
    """(eu, ev) of an n-node chain with a skip edge (u -> u + 2..8) from
    about every third node, in producer order as a CompiledGraph orders
    them."""
    rng = np.random.default_rng(seed)
    edges = {(u, u + 1) for u in range(n - 1)}
    for u in range(0, n - 2, 3):
        edges.add((u, min(n - 1, u + int(rng.integers(2, 9)))))
    eu, ev = zip(*sorted(edges))
    return eu, ev


def ga_graphs() -> list:
    """The label-kernel cases: (name, eu, ev, n, rows); the 820- and
    830-node chains sit either side of the plan's warp/block crossover on an
    H100 (19127 and 19354 words a warp block of eight rows, against a third
    of a block's shared memory, 19285); the 29928-node chain's rows do not fit shared memory (2 n words
    already too many), so it runs the global-memory variant; the last ones
    are the engine's batches."""
    out = []
    zoo = {wl: build_workload(wl).compiled()
           for wl in ("mobilenet_v3", "resnet50")}
    for wl, cg in zoo.items():
        out.append((wl, cg.eu, cg.ev, cg.n, GA_ROWS))
    for n in (820, 830):
        eu, ev = chain_with_skips(n, seed=7)
        out.append((f"chain{n}_skips", eu, ev, n, GA_ROWS))
    eu, ev = chain_with_skips(1040, seed=5)
    out.append(("chain1040_skips", eu, ev, 1040, GA_ROWS))
    n_long = ga_card().shared_words // 2 + 1000
    eu, ev = chain_with_skips(n_long, seed=6)
    out.append((f"chain{n_long}_skips", eu, ev, n_long, GA_LONG_ROWS))
    for wl, rows in GA_BATCHES:
        cg = zoo[wl]
        out.append((wl, cg.eu, cg.ev, cg.n, rows))
    return out


def ga_table_words(tb, variant: str) -> int:
    """int32 words of the static tables ``variant`` reads: the chain edge
    into each node (warp) or the chain's nodes and edge ids (block,
    global), and the extra edges' ids and end nodes."""
    chain = ((tb.chain_into,) if variant == "warp"
             else (tb.chain_nodes, tb.chain_eids))
    return sum(x.numel() for x in chain + (tb.extra_eids, tb.xu, tb.xv))


def kernels_ga(timer: Timer, g, graphs=None) -> list:
    """The group-label kernel against its plain version on the card, bit for
    bit, at each graph of ``graphs`` (default ``ga_graphs()``) and density of GA_DENSITIES (rows 0
    and 1 all-zero and all-one): the variant ``plan`` picks must be the one
    that runs, and every variant that can take the case is forced, checked
    and timed (``ms``: the plan's), beside the bytes bound (bits in, int32
    labels out, the tables) and a bare launch (``torch.cuda._sleep(0)``,
    the floor at the engine's batch sizes)."""
    bare = timer.ms(lambda: torch.cuda._sleep(0))
    cases = []
    for name, eu, ev, n, rows in graphs or ga_graphs():
        tb = label_tables(eu, ev, n, DEV)
        m, n_extra = len(eu), tb.xu.numel()
        variants = ga_variants(n, m, n_extra, ga_card().shared_words)
        how = ga_plan(rows, n, m, n_extra, ga_card())
        for density in GA_DENSITIES:
            bits = (torch.rand(rows, m, generator=g, device=DEV)
                    < density).to(torch.uint8)
            bits[0] = 0
            bits[1] = 1
            before = dict(ga_labels.variant_launches)
            out = ga_labels(bits, tb)
            ran = ran_variant(ga_labels, before)
            ref = ga_labels_ref(bits, tb)
            err = {}
            for v in variants:
                got = ga_labels(bits, tb, variant=v).long()
                err[v] = (got - ref).abs().max().item()
                if not torch.equal(got, ref):
                    raise AssertionError(f"ga_labels {name} x {rows} density "
                                         f"{density}: variant {v} max abs "
                                         f"error {err[v]}")
            if ran != how.variant or not torch.equal(out.long(), ref):
                raise AssertionError(f"ga_labels {name} x {rows} density "
                                     f"{density}: ran {ran} (planned "
                                     f"{how.variant})")
            t = {v: timer.ms(lambda: ga_labels(bits, tb, variant=v))
                 for v in variants}
            nbytes = (bits.numel() + out.numel() * 4
                      + 4 * ga_table_words(tb, ran))
            case = {"case": name, "nodes": n, "edges": m,
                    "extra_edges": n_extra, "rows": rows,
                    "density": density, "variant": ran,
                    "rows_per_block": how.rows_per_block,
                    "max_abs_err": max(err.values()),
                    "ms": t[ran], "ms_by_variant": t,
                    "bare_launch_ms": bare,
                    "plain_ms": timer.ms(lambda: ga_labels_ref(bits, tb),
                                         reps=3),
                    "library_ms": None,     # no one call labels components
                    **bound(nbytes, 0, torch.float32)}
            log(f"[kernels] ga_labels {case}")
            cases.append(case)
            del bits, out, ref
    return cases


def phase_kernels(timer: Timer) -> dict:
    g = torch.Generator(device=DEV).manual_seed(1234)

    def rn(*shape, dt):
        return torch.randn(*shape, generator=g, device=DEV).to(dt)

    rows = kernels_rmsnorm(timer, rn)
    rows["flash_attention"] = kernels_flash(timer, rn)
    rows["rglru_scan"] = kernels_rglru(timer, g)
    rows["rglru_gated"] = kernels_rglru_gated(timer, g)
    rows["mamba_scan"] = kernels_mamba(timer, g)
    rows["ga_labels"] = kernels_ga(timer, g)
    torch.cuda.empty_cache()
    return rows


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def reset_counts() -> None:
    for f in COUNTERS.values():
        f.launches = 0
    fused_rmsnorm.residual_launches = 0
    fused_rmsnorm.variant_launches = dict.fromkeys(
        fused_rmsnorm.variant_launches, 0)
    flash_attention.impl_launches = dict.fromkeys(
        flash_attention.impl_launches, 0)
    ga_labels.variant_launches = dict.fromkeys(ga_labels.variant_launches, 0)
    rglru_scan.variant_launches = dict.fromkeys(rglru_scan.variant_launches,
                                                0)


def read_counts() -> dict:
    counts = {name: f.launches for name, f in COUNTERS.items()}
    counts["rmsnorm_residual"] = fused_rmsnorm.residual_launches
    counts["rmsnorm"] -= counts["rmsnorm_residual"]
    return {k: counts[k] for k in KERNELS}


def expected_launches(cfg, new: int) -> dict:
    """What ``generate`` launches: one prefill and new - 1 decode steps run
    every norm (two a layer outside the ssm family, one inside, plus the
    final one), every attention layer and every RG-LRU layer (the gated
    kernel, prefill and decode step alike); the Mamba scan runs in the
    prefill only (its decode step is plain torch ops); neither the residual
    form nor the RG-LRU interface entry is on the path."""
    kinds = cfg.layer_kinds()
    norms = len(kinds) * (1 if cfg.family == "ssm" else 2) + 1
    return {"rmsnorm": norms * new, "rmsnorm_residual": 0,
            "flash_attention": sum(k.startswith("attn") for k in kinds) * new,
            "rglru_scan": 0, "rglru_gated": kinds.count("rglru") * new,
            "mamba_scan": kinds.count("mamba"), "ga_labels": 0}


def expected_flash_impls(cfg, new: int) -> dict:
    """Which flash kernel ``generate`` runs: every attention layer's prefill
    on the tensor cores in bf16, on the SIMT kernel in fp32; its new - 1
    decode steps (one query a sequence) on the decode kernel the plan
    picks for the config's heads: ``warp_decode`` at up to R_MAX query
    heads per kv head, else ``split_decode``."""
    attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    bf16 = cfg.param_dtype == "bfloat16"
    impls = dict.fromkeys(flash_attention.impl_launches, 0)
    if attn:
        decode = flash_plan(1, 1, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim,
                            torch.bfloat16 if bf16 else torch.float32, 1)
        impls[decode.impl] = attn * (new - 1)
        impls["tc_prefill" if bf16 else "simt"] = attn
    return impls


def check_launches(cfg, new: int, res: dict) -> None:
    """A serve run's launch counts must be exactly as expected, and so must
    the flash kernel each attention call went to; every norm runs
    RMSNorm's ``vector`` variant."""
    expect = expected_launches(cfg, new)
    if res["launches"] != expect:
        raise AssertionError(f"{cfg.name}: launches {res['launches']} != "
                             f"{expect}")
    impls = expected_flash_impls(cfg, new)
    if res["flash_impls"] != impls:
        raise AssertionError(f"{cfg.name}: flash kernels "
                             f"{res['flash_impls']} != {impls}")
    norms = {"vector": expect["rmsnorm"] + expect["rmsnorm_residual"],
             "generic": 0}
    if res["rmsnorm_variants"] != norms:
        raise AssertionError(f"{cfg.name}: rmsnorm variants "
                             f"{res['rmsnorm_variants']} != {norms}")


def kernel_kind(name: str) -> str:
    """A device kernel's short name: the port's kernels by their entry,
    cuBLAS's products as ``gemm``, PyTorch's by their function name."""
    low = name.lower()
    for key, kind in (("gated<", "rglru_gated"), ("direct<", "rglru_scan"),
                      ("rglru_scan_kernel", "rglru_scan"),
                      ("flash", "flash_attention"), ("rmsnorm", "rmsnorm"),
                      ("mamba", "mamba_scan"), ("gemm", "gemm"),
                      ("nvjet", "gemm"), ("xmma", "gemm")):
        if key in low:
            return kind
    short = name.removeprefix("void ").split("<")[0].split("(")[0]
    return short.rsplit("::", 1)[-1]


# the port's kernels by the block that launches them (``profile_window``)
PORT_BLOCKS = {"rmsnorm": "norm", "flash_attention": "attn",
               "rglru_gated": "rglru", "rglru_scan": "rglru",
               "mamba_scan": "mamba"}


def profile_window(model, run) -> dict:
    """One ``torch.profiler`` window (CPU and CUDA) over ``run()``, with a
    range around each layer's norms, mixer and MLP (forward hooks): host ms
    (synchronised), device ms (the kernels' summed durations: one stream,
    so they do not overlap), the device's idle share, and device ms by
    block, by kernel and, inside the RG-LRU blocks, by op (the innermost
    PyTorch op that launched a kernel).  A PyTorch kernel goes to the block
    whose range holds the ``aten::`` op it is linked to, or to ``other``
    (embedding, unembedding); the profiler also links some kernels to
    runtime events (a full launch queue), which would count them twice, so
    those links are not read.  The port's kernels, launched through ctypes
    outside any op, go to their block by name (PORT_BLOCKS: the final
    norm's RMSNorm counts as ``norm``).  The ranges' own device-side
    annotations are not kernels and are left out; ``unattributed_ms`` is
    what no op claimed."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    open_ranges, hooks = [], []

    def enter(name):
        def pre(mod, args):
            open_ranges.append(record_function(name).__enter__())
        return pre

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for layer in model.layers:
        for child in ("norm1", layer.mixer, "norm2", "mlp"):
            if hasattr(layer, child):
                mod = getattr(layer, child)
                name = "block:norm" if child.startswith("norm") \
                    else f"block:{child}"
                hooks += [mod.register_forward_pre_hook(enter(name)),
                          mod.register_forward_hook(leave)]
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
    return dict(host_ms=host_ms, **device_breakdown(prof.events(), host_ms))


def device_breakdown(events, host_ms: float) -> dict:
    """``profile_window``'s sums over a profiler's events."""
    from torch.autograd import DeviceType
    by_kernel, by_block, rglru_ops = {}, {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                "block:"):
            k = kernel_kind(e.name) or "(unnamed)"
            by_kernel[k] = (by_kernel.get(k, 0.0)
                            + e.time_range.elapsed_us() / 1e3)
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[6:])
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith("block:"))
    starts = [r[0] for r in ranges]
    for kind, block in PORT_BLOCKS.items():
        if kind in by_kernel:
            by_block[block] = by_block.get(block, 0.0) + by_kernel[kind]
            if block == "rglru":
                rglru_ops[kind] = by_kernel[kind]
    for e in events:
        if (e.device_type != DeviceType.CPU or not e.kernels
                or not e.name.startswith("aten::")):
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        block = ranges[i][2] if i >= 0 and t <= ranges[i][1] else "other"
        for k in e.kernels:
            if kernel_kind(k.name) in PORT_BLOCKS:
                continue
            ms = k.duration / 1e3
            by_block[block] = by_block.get(block, 0.0) + ms
            if block == "rglru":
                rglru_ops[e.name] = rglru_ops.get(e.name, 0.0) + ms
    device_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16])
    return {"device_ms": device_ms,
            "idle_share": 1 - device_ms / host_ms if host_ms else None,
            "by_block_ms": by_block,
            "unattributed_ms": device_ms - sum(by_block.values()),
            "by_kernel_ms": top,
            "rglru_block_by_op_ms": dict(sorted(rglru_ops.items(),
                                                key=lambda kv: -kv[1]))}


def layer_profile(model, prompts, img, new) -> dict:
    """One prefill of ``prompts`` and one decode step after it, each in its
    own ``profile_window``; raises if the profiler shows no device time."""
    S = prompts.shape[1] + (0 if img is None else img.shape[1])
    state = {}

    def prefill():
        state["cache"] = model.prefill(prompts, max_len=S + new,
                                       img_embeds=img)[1]

    def decode():
        model.decode_step(prompts[:, :1], S, state["cache"])

    out = {"prefill": profile_window(model, prefill),
           "decode_step": profile_window(model, decode)}
    if not all(w["device_ms"] > 0 for w in out.values()):
        raise AssertionError(f"the profiler shows no device time: {out}")
    return out


def serve_check(cfg, batch, prompt, new, label, warm=False, profile=False):
    """generate() then one forward over prompt + generated tokens; the
    decode logits must match the forward's at the same positions (only
    those are unembedded: recurrentgemma-2b's (8, 4127, 256000) fp32 logits
    would take 34 GB): in fp32 within SERVE_REL_TOL_FP32, in bf16 within the
    rounding floor (FLOOR_MULT), for which the model is then cast to fp32.
    ``profile``: after the counted run, ``layer_profile`` of a prefill and
    a decode step."""
    g = torch.Generator(device=DEV).manual_seed(0)
    model = Transformer(cfg, DEV, generator=g)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=DEV)
    img = None
    if cfg.img_tokens:            # as serve.main draws them
        img = torch.randn(batch, cfg.img_tokens, cfg.d_model, generator=g,
                          device=DEV).to(model.dtype)
    if warm:                      # cuBLAS handles, allocator: not timed
        generate(model, prompts[:, :16], 2,
                 None if img is None else img[:, :16])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = generate(model, prompts, new, img)
    launches = read_counts()
    flash_impls = dict(flash_attention.impl_launches)
    norm_variants = dict(fused_rmsnorm.variant_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = layer_profile(model, prompts, img, new) if profile else None
    if out.tokens.shape != (batch, new) or out.logits.shape != (
            batch, new, cfg.vocab) or not torch.isfinite(out.logits).all():
        raise AssertionError(f"{label}: bad generate output")
    full = torch.cat([prompts, out.tokens[:, :-1]], 1)
    ref = model(full, last=new, img_embeds=img)
    err = rel_rms(out.logits, ref)
    agree = (out.logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    bf16 = cfg.param_dtype == "bfloat16"
    if bf16:                      # the same weights in fp32 arithmetic
        ref32 = model.float()(full, last=new, img_embeds=img)
        floor = rel_rms(ref, ref32)
        check = {"decode_rel_rms_vs_fp32_forward": rel_rms(out.logits, ref32),
                 "bf16_forward_rel_rms_vs_fp32_forward": floor,
                 "limit": FLOOR_MULT * floor}
        del ref32
    else:
        check = {"limit": SERVE_REL_TOL_FP32}
    res = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": batch, "prompt": prompt, "img_tokens": cfg.img_tokens,
           "tokens": new,
           "prefill_ms": out.prefill_s * 1e3,
           "decode_ms_per_step": out.decode_s * 1e3 / max(new - 1, 1),
           "decode_tok_per_s": batch * (new - 1) / out.decode_s,
           "peak_mem_gb": peak_gb, "launches": launches,
           "flash_impls": flash_impls, "rmsnorm_variants": norm_variants,
           "logits_rel_rms_vs_forward": err,
           "logits_max_abs_diff": (out.logits - ref).abs().max().item(),
           "argmax_agreement": agree, **check}
    if prof is not None:
        res["profile"] = prof
    log(f"[serve] {label} {json.dumps(res)}")
    checked = check["decode_rel_rms_vs_fp32_forward"] if bf16 else err
    if not checked <= check["limit"]:
        raise AssertionError(f"{label}: decode logits relative RMS error "
                             f"{checked:.3e} > {check['limit']:.3e}")
    del model, out, ref, full, prompts, img
    torch.cuda.empty_cache()
    return res


def phase_serve() -> dict:
    """Each model in turn (the previous one freed), counts set to 0 just
    before its run and read just after (``check_launches``)."""
    runs = {}
    for arch, batch, prompt, new in SERVES:
        cfg = get_config(arch)
        res = serve_check(cfg, batch, prompt, new, f"bf16 full {arch}",
                          warm=True, profile=arch == "recurrentgemma-2b")
        check_launches(cfg, new, res)
        runs[arch] = res
    return runs


def phase_fp32() -> dict:
    """Phase 5; returns its full-width runs by label, counted as phase 4's
    are (their prefills are where the SIMT kernel runs on a model path)."""
    runs = {}
    for arch, layers in (("chatglm3-6b", 2), ("recurrentgemma-2b", 3),
                         ("falcon-mamba-7b", 2), ("phi-3-vision-4.2b", 2)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  param_dtype="float32")
        label = f"fp32 {layers}-layer {arch}"
        res = serve_check(cfg, 8, FP32_PROMPT, 8, label)
        check_launches(cfg, 8, res)
        runs[label] = res
    # each reduced config: CUDA kernels vs the plain CPU path, same weights;
    # recurrentgemma's prompt of 21 is longer than its 16-slot buffer
    for arch, _, _, _ in SERVES:
        small = dataclasses.replace(get_reduced(arch), param_dtype="float32")
        gpu = Transformer(small, DEV, seed=3)
        cpu = Transformer(small, "cpu")
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
        g = torch.Generator().manual_seed(4)
        toks = torch.randint(0, small.vocab, (2, 37), generator=g)
        img = (torch.randn(2, small.img_tokens, small.d_model, generator=g)
               if small.img_tokens else None)
        img_dev = None if img is None else img.to(DEV)
        err = close(gpu(toks.to(DEV), img_embeds=img_dev).cpu(),
                    cpu(toks, img_embeds=img), 1e-4)
        gen_gpu = generate(gpu, toks[:, :21].to(DEV), 6, img_dev)
        gen_cpu = generate(cpu, toks[:, :21], 6, img)
        err_gen = close(gen_gpu.logits.cpu(), gen_cpu.logits, 1e-4)
        log(f"[serve] reduced {small.name} cuda vs cpu plain path: max abs "
            f"err forward {err:.3e}, generate {err_gen:.3e} (tol 1e-4 abs + "
            f"rel: fp32, sums in another order)")
    return runs


def phase_search() -> dict:
    """Each GA_RUNS search through a ``SearchSession`` on the card, counts
    set to 0 just before it and read just after: the reference's genome,
    fitness and evaluations exactly; one label-kernel launch per engine
    batch, through the ``warp`` variant, and no other kernel."""
    runs = {}
    for label, run in GA_RUNS.items():
        session = SearchSession(SearchSpec(**run["spec"]), device=DEV)
        reset_counts()
        art = session.run()
        launches = read_counts()
        variants = dict(ga_labels.variant_launches)
        eng = session.evaluator.population().stats()
        got = dict(genome_mask=art.genome_mask, best_fitness=art.best_fitness,
                   evaluations=art.evaluations)
        st = art.backend_stats
        res = {"name": label, **run["spec"],
               "offspring_evaluated": art.offspring_evaluated,
               "unique_states": art.evaluations,
               "best_fitness": art.best_fitness,
               "genome_mask": hex(art.genome_mask),
               "evals_per_sec": art.offspring_evaluated / art.wall_s,
               "batch_evals_per_sec": st["batch_evals_per_sec"],
               "pop_backend": st["pop_backend"], "wall_s": art.wall_s,
               "group_cache_entries": st["unique_groups"],
               "group_hit_rate": st["group_hit_rate"],
               "pop_batches": st["pop_batches"],
               "batch_time_s": st["batch_time_s"],
               "label_launches": eng["label_launches"],
               "label_time_s": eng["label_time_s"],
               "label_kernel_s": eng["label_kernel_s"],
               "label_share_of_batch_time":
                   eng["label_time_s"] / st["batch_time_s"],
               "kernel_share_of_batch_time":
                   eng["label_kernel_s"] / st["batch_time_s"],
               "launches": launches, "label_variants": variants}
        log(f"[search] {json.dumps(res)}")
        if got != run["golden"]:
            raise AssertionError(f"{label}: {got} != reference "
                                 f"{run['golden']}")
        expect = dict.fromkeys(KERNELS, 0)
        expect["ga_labels"] = eng["batches"]
        if (st["pop_backend"] != "cuda" or not eng["batches"]
                or launches != expect
                or variants != {"warp": eng["batches"], "block": 0,
                                "global": 0}
                or eng["label_launches"] != eng["batches"]):
            raise AssertionError(f"{label}: launches {launches}, variants "
                                 f"{variants}, engine {eng}")
        runs[label] = res
    return runs


# ---- phase 7: the schedule service --------------------------------------------------

# the README's serve jobs: the same island search twice (deduplicated in
# flight), then resnet50 on a repartitioned eyeriss with the ga defaults
SERVE_JOBS = [
    {"workload": "mobilenet_v3", "backend": "island",
     "backend_config": {"islands": 4, "preset": "fast", "generations": 60}},
    {"workload": "mobilenet_v3", "backend": "island",
     "backend_config": {"islands": 4, "preset": "fast", "generations": 60}},
    {"workload": "resnet50", "accelerator": "eyeriss@act+64"},
]
SERVICE_DIR = ROOT / "build" / "schedule_service"


def island_run(islands: int, device: str) -> dict:
    """One ISLAND_RUNS search through a ``SearchSession`` on ``device``,
    counts set to 0 just before it and read just after.  Held to the
    reference's result exactly; on the card every island's engine must be
    ``cuda`` with one label launch per batch (islands 2 and 4 run in
    spawned processes, whose launches come back in their engine stats;
    islands 1 is the ga backend in this process, counted here)."""
    spec = SearchSpec(**ISLAND_SPEC, backend_config=island_config(islands))
    session = SearchSession(spec, device=device)
    reset_counts()
    art = session.run()
    launches = read_counts()
    backend = session.backend
    got = dict(genome_mask=art.genome_mask, best_fitness=art.best_fitness,
               history_len=len(art.history), evaluations=art.evaluations,
               offspring_evaluated=art.offspring_evaluated)
    if islands == 1:
        engines = [{**session.evaluator.population().stats(),
                    "label_variants": dict(ga_labels.variant_launches)}]
    else:
        engines = [info["engine"] for info in backend.island_info]
    child = sum(e["label_launches"] for e in engines) if islands > 1 else 0
    first_gen = [info["first_gen_s"] for info in backend.island_info]
    res = {"name": "island_scaling", "islands": islands, "generations": 60,
           "seed": spec.seed, "workload": spec.workload,
           "accelerator": spec.accelerator, "cpu_count": os.cpu_count(),
           "wall_s": art.wall_s,
           "evals_per_sec": art.offspring_evaluated / art.wall_s,
           "offspring_evaluated": art.offspring_evaluated,
           "best_fitness": art.best_fitness, "device": device,
           "start_method": backend.start_method,
           "spawn_to_first_gen_s": max(first_gen) if first_gen else None,
           "engines": [{k: e[k] for k in ("backend", "batches",
                                          "label_launches", "batch_time_s")}
                       for e in engines],
           "launches": launches, "child_launches": {"ga_labels": child}}
    log(f"[island] {json.dumps(res)}")
    if got != ISLAND_RUNS[islands]:
        raise AssertionError(f"island x{islands} on {device}: {got} != "
                             f"reference {ISLAND_RUNS[islands]}")
    want_method = None if islands == 1 else "spawn"   # CUDA is live here
    if backend.start_method != want_method or len(engines) != islands:
        raise AssertionError(f"island x{islands} on {device}: start "
                             f"{backend.start_method}, {len(engines)} "
                             f"engines")
    expect = dict.fromkeys(KERNELS, 0)
    if device == DEV:
        expect["ga_labels"] = engines[0]["batches"] if islands == 1 else 0
        for e in engines:
            if (e["backend"] != "cuda" or not e["batches"]
                    or e["label_launches"] != e["batches"]
                    or sum(e["label_variants"].values()) != e["batches"]):
                raise AssertionError(f"island x{islands}: engine {e}")
    elif any(e["backend"] != "torch" or e["label_launches"]
             for e in engines):
        raise AssertionError(f"island x{islands} on cpu: {engines}")
    if launches != expect:
        raise AssertionError(f"island x{islands} on {device}: launches "
                             f"{launches} != {expect}")
    return res


def cli(*argv, env=None) -> tuple:
    """``python -m repro_torch <argv>`` in the service directory: (exit
    code, stdout, seconds); a failure shows its output."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", *argv], cwd=SERVICE_DIR,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env or {})})
    secs = time.perf_counter() - t0
    log(f"[cli] {' '.join(argv)}: rc {r.returncode} in {secs:.1f} s")
    if r.returncode != 0:
        raise AssertionError(f"python -m repro_torch {' '.join(argv)}: rc "
                             f"{r.returncode}\n{r.stdout}\n{r.stderr}")
    return r.stdout, secs


def service_cli() -> dict:
    """The CLI's main path in subprocesses, each search on the card: an
    island search with telemetry and a trace, its report (certificate,
    verification, telemetry), a served batch (the README's jobs), a submit
    served from the store with zero new evaluations (its trace holds no
    search and no batch), ``verify --store`` and ``trace``."""
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    SERVICE_DIR.mkdir(parents=True)
    (SERVICE_DIR / "jobs.json").write_text(json.dumps(SERVE_JOBS))
    out = {}
    _, out["search_s"] = cli(
        "search", "--workload", "mobilenet_v3", "--accelerator", "simba",
        "--backend", "island", "--backend-config",
        json.dumps(island_config(4)), "--seed", "0", "--telemetry",
        "--trace", "run.jsonl", "--out", "a.json")
    art = json.loads((SERVICE_DIR / "a.json").read_text())
    got = dict(genome_mask=int(art["genome_mask"], 16),
               best_fitness=art["best_fitness"],
               history_len=len(art["history"]),
               evaluations=art["evaluations"],
               offspring_evaluated=art["offspring_evaluated"])
    if got != ISLAND_RUNS[4] or art["telemetry"]["steps"] < 1:
        raise AssertionError(f"cli search: {got}")
    report, out["report_s"] = cli("report", "a.json", "--telemetry")
    for want in ("certificate  : DRAM traffic",
                 "verification : all checks passed", "telemetry    :",
                 "engine cuda"):
        if want not in report:
            raise AssertionError(f"cli report lacks {want!r}:\n{report}")
    served, out["serve_s"] = cli("serve", "--store", "S", "--requests",
                                 "jobs.json", "--workers", "2", "--json")
    stats = json.loads(served)["stats"]
    if stats != {"jobs": 3, "searched": 2, "cache_hits": 1,
                 "deduped_in_flight": 1, "failed": 0}:
        raise AssertionError(f"cli serve: {stats}")
    submitted, out["submit_s"] = cli(
        "submit", "--store", "S", "--workload", "mobilenet_v3", "--backend",
        "island", "--backend-config", json.dumps({"islands": 4}),
        "--preset", "fast", "--generations", "60",
        env={"REPRO_TRACE": str(SERVICE_DIR / "submit.jsonl")})
    sub = [json.loads(line) for line in
           (SERVICE_DIR / "submit.jsonl").read_text().splitlines()]
    names = [e["name"] for e in sub]
    if not submitted.startswith("served from store") or "search" in names \
            or "batch_eval" in names or names.count("serve.job") != 1:
        raise AssertionError(f"cli submit: {submitted}\n{names}")
    verified, out["verify_s"] = cli("verify", "--store", "S")
    if "2 artifact(s): 2 verified, 0 failed" not in verified:
        raise AssertionError(f"cli verify:\n{verified}")
    traced, out["trace_s"] = cli("trace", "run.jsonl", "--json")
    agg = json.loads(traced)
    if not agg["valid"] or agg["span_counts"].get("generation") != \
            art["telemetry"]["steps"]:
        raise AssertionError(f"cli trace: {agg['span_counts']}")
    stored = [json.loads(p.read_text())
              for p in sorted((SERVICE_DIR / "S" / "objects").rglob("*.json"))]
    backends = [a["backend_stats"]["pop_backend"] for a in stored]
    if backends != ["cuda", "cuda"]:
        raise AssertionError(f"stored artifacts' engines: {backends}")
    out.update(serve_stats=stats, stored_pop_backends=backends,
               trace_spans=agg["span_counts"],
               serve_job_wall_s=[a["wall_s"] for a in stored])
    log(f"[cli] {json.dumps(out)}")
    return out


def phase_service() -> dict:
    """Phase 7: ISLAND_RUNS at 1, 2 and 4 islands on the card (spawned
    island processes) and the same with ``device="cpu"`` beside them, then
    the CLI's main path in subprocesses.  Returns the card's island runs,
    counted with phase 4-6's runs."""
    t0 = time.perf_counter()
    runs = {}
    for islands in (1, 2, 4):
        runs[f"island_x{islands}"] = island_run(islands, DEV)
        island_run(islands, "cpu")
    service_cli()
    log(f"[service] phase 7 took {time.perf_counter() - t0:.1f} s")
    return runs


def depth_sweep() -> None:
    """falcon-mamba-7b's serve check (bf16: decode vs forward and the
    rounding floor) at 8, 16, 32 and 64 layers, and in fp32 at 64."""
    arch, batch, prompt, new = SERVES[2]
    for layers, dt in ((8, "bfloat16"), (16, "bfloat16"), (32, "bfloat16"),
                       (64, "bfloat16"), (64, "float32")):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  param_dtype=dt)
        serve_check(cfg, batch, prompt, new, f"sweep {dt} {layers}-layer")


def label_sweep() -> None:
    """The label kernel's variants on chains with skips from 340 to 1040
    nodes (906 to 2772 words a row) at 65536 genomes: phase 3's checks and
    times, to place the plan's warp/block crossover."""
    graphs = []
    for n in LABEL_SWEEP:
        eu, ev = chain_with_skips(n, seed=7)
        graphs.append((f"chain{n}_skips", eu, ev, n, GA_ROWS))
    kernels_ga(Timer(), torch.Generator(device=DEV).manual_seed(1234),
               graphs)


def decode_sweep() -> None:
    """Both decode kernels in bf16 over a 2049-key cache of 32 kv heads
    (phi-3-vision-4.2b's decode at G 1) with G = DECODE_SWEEP_ROWS query
    heads per kv head, at head_dim 96 and 128: ``warp_decode`` forced at
    each of DECODE_SWEEP_SPLITS splits and at the plan's, ``split_decode``
    forced at its plan, each checked against the plain version (TOL and
    FLASH_ROW_TOL) and timed beside SDPA and the bound.  One line a shape;
    the plan's R_MAX and WARP_MIN_BLOCKS are read from them."""
    timer = Timer()
    g = torch.Generator(device=DEV).manual_seed(1234)
    dt, Skv, Hkv = torch.bfloat16, 2080, 32
    kw = dict(q_offset=2048, kv_len=2049)
    shapes = [(D, 8, r) for D in (96, 128) for r in DECODE_SWEEP_ROWS]
    shapes += [(D, 2, r) for D in (96, 128) for r in DECODE_SWEEP_SMALL]
    for D, B, rows in shapes:
        Hq = Hkv * rows
        q, k, v = (torch.randn(*s, generator=g, device=DEV).to(dt)
                   for s in ((B, 1, Hq, D), (B, Skv, Hkv, D),
                             (B, Skv, Hkv, D)))
        ref = attention_ref(q, k, v, **kw)
        plans = {f"warp_decode_s{n}": flash_plan(
            B, 1, Hq, Hkv, D, dt, 2049, impl="warp_decode", splits=n)
            for n in DECODE_SWEEP_SPLITS}
        plans["warp_decode_plan"] = flash_plan(B, 1, Hq, Hkv, D, dt, 2049,
                                               impl="warp_decode")
        plans["split_decode_plan"] = flash_plan(B, 1, Hq, Hkv, D, dt, 2049,
                                                impl="split_decode")
        row = {"head_dim": D, "batch": B, "rows_per_kv_head": rows,
               "plan": flash_plan(B, 1, Hq, Hkv, D, dt, 2049).impl}
        # each entry: its splits, tiles a split, blocks and time
        for name, how in plans.items():
            forced = None if name.endswith("_plan") else how.splits

            def call(how=how, forced=forced):
                return flash_attention(q, k, v, impl=how.impl,
                                       splits=forced, **kw)
            flash_check(f"sweep {name} D {D} G {rows}", call(), ref, dt)
            row[name] = {"splits": how.splits,
                         "tiles_per_split": how.tiles_per_split,
                         "blocks": how.blocks, "ms": timer.ms(call)}
        row["library_ms"] = timer.ms(sdpa_call(q, k, v, True, 0, 2048, 2049,
                                               None))
        row.update(flash_work(B, 1, Skv, Hq, Hkv, D, dt, **kw))
        log(f"[sweep] {json.dumps(row)}")
        del q, k, v, ref


def scan_sweep() -> None:
    """Both RG-LRU entries at recurrentgemma-2b's prefill shape (8, 4096,
    2560), bf16 and fp32: the ring at every tile of SCAN_SWEEP_CHANNELS x
    SCAN_SWEEP_STEPS (steps a thread) x SCAN_SWEEP_SPLITS (threads a
    channel) x SCAN_SWEEP_STAGES that fits the kernel, each checked (TOL x
    RGLRU_TOL_MULT) and timed, beside the plan's tile, the ``simple``
    variant and, for the gated entry, today's layer path.  One line a tile;
    the plan's TILES are read from them."""
    timer = Timer()
    g = torch.Generator(device=DEV).manual_seed(1234)
    Bs, S, Wd, _ = rglru_shapes()[0]
    for dt in (torch.bfloat16, torch.float32):
        tol, tol_last = (TOL[dt] * RGLRU_TOL_MULT,
                         TOL[torch.float32] * RGLRU_TOL_MULT)
        a, b = rglru_scan_inputs(g, Bs, S, Wd, dt)
        args, _ = rglru_gated_inputs(g, Bs, S, Wd, dt)
        ref = rglru_scan_ref(a, b)
        ref_g, ref_last = rglru_gated_ref(*args)
        base = {"shape": [Bs, S, Wd], "dtype": str(dt)[6:]}
        fixed = {"interface": {
            "plan": lambda: rglru_scan(a, b),
            "simple": lambda: rglru_scan(a, b, variant="simple")},
            "gated": {"plan": lambda: rglru_gated(*args),
                      "today": lambda: rglru_today(*args)}}
        for entry, fns in fixed.items():
            t = in_turns(timer, fns)
            how = rglru_plan(Bs, S, Wd, dt, gated=entry == "gated")
            log(f"[sweep] {json.dumps(dict(base, entry=entry, plan=plan_fields(how), ms=t))}")
        for C, L, G, P in itertools.product(
                SCAN_SWEEP_CHANNELS, SCAN_SWEEP_STEPS, SCAN_SWEEP_SPLITS,
                SCAN_SWEEP_STAGES):
            tile = (C, L * G, P, G)
            row = dict(base, channels=C, steps=L * G, split=G, stages=P)
            for entry in ("interface", "gated"):
                try:
                    how = rglru_plan(Bs, S, Wd, dt, gated=entry == "gated",
                                     tile=tile)
                except ValueError:
                    row[entry] = "beyond the kernel's limits"
                    continue
                if entry == "gated":
                    def call():
                        return rglru_gated(*args, tile=tile)
                    h, h_last = call()
                    err = max(close(h, ref_g, tol),
                              close(h_last, ref_last, tol_last))
                else:
                    def call():
                        return rglru_scan(a, b, tile=tile)
                    err = close(call(), ref, tol)
                row[entry] = {"ms": timer.ms(call), "max_abs_err": err,
                              "smem_bytes": how.smem_bytes,
                              "threads": how.threads, "blocks": how.blocks}
            log(f"[sweep] {json.dumps(row)}")
        del a, b, args, ref, ref_g, ref_last
        torch.cuda.empty_cache()


def kernel_line(rows: dict, runs: dict) -> dict:
    """One entry per kernel; its top-level numbers are those of its first
    timed case (a serve shape in bf16, the scans in fp32 as the models run
    them, the group labels at mobilenet_v3 and density 0.5), the other cases
    are listed under ``cases``; ``launches`` is the sum over the main-path
    runs (serve, phase 5's full-width fp32 runs, search and phase 7's
    island runs) counted in this process, each run's under
    ``launches_by_run``; the group labels launched by phase 7's spawned
    island processes are under ``launches_in_island_processes``.  Flash attention has one entry per kernel
    that ran (each case's ``impl``, each run's ``flash_impls``)."""
    flash = "src/repro/kernels/flash_attention/kernel.py:78 " \
            "(flash_attention_kernel)"
    meta = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:34 (rmsnorm_kernel)"),
        "rmsnorm_residual": (
            "src/repro_torch/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm/kernel.py:34 (rmsnorm_kernel, "
            "residual form)"),
        "tc_prefill": ("src/repro_torch/csrc/flash_prefill_tc.cu", flash),
        "split_decode": ("src/repro_torch/csrc/flash_decode.cu", flash),
        "warp_decode": ("src/repro_torch/csrc/flash_decode.cu", flash),
        "simt": ("src/repro_torch/csrc/flash_attention.cu", flash),
        "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                       "src/repro/kernels/rglru_scan/kernel.py:39 "
                       "(rglru_scan_kernel)"),
        "rglru_gated": ("src/repro_torch/csrc/rglru_scan.cu",
                        "src/repro/kernels/rglru_scan/kernel.py:39 "
                        "(rglru_scan_kernel) with the gate arithmetic of "
                        "src/repro/models/rglru.py:75-89"),
        "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                       "src/repro/kernels/mamba_scan/kernel.py:48 "
                       "(mamba_scan_kernel)"),
        "ga_labels": ("src/repro_torch/csrc/ga_labels.cu",
                      "src/repro/core/population.py:598 (_build_jax_labels, "
                      "jitted JAX, no pallas_call; body :619-646)"),
    }
    # (entry, cases, launches by run)
    entries = []
    for name in KERNELS:
        if name != "flash_attention":
            entries.append((name, rows[name], {
                r: res["launches"][name] for r, res in runs.items()}))
            continue
        for impl in flash_attention.impl_launches:
            entries.append((f"flash_attention_{impl}",
                            [c for c in rows[name] if c["impl"] == impl],
                            {r: res.get("flash_impls", {}).get(impl, 0)
                             for r, res in runs.items()}))
    out = []
    for name, cases, by_run in entries:
        source, replaces = meta[name.removeprefix("flash_attention_")]
        main = next(c for c in cases if "ms" in c)
        # phase 7's spawned islands launch in their own processes: counted
        # from their engine stats, apart from this process's counters
        children = {r: res["child_launches"][name] for r, res in runs.items()
                    if res.get("child_launches", {}).get(name)}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            **({"launches_in_island_processes": children} if children
               else {}),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "cases": cases})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth-sweep", action="store_true",
                    help="build, then only the falcon-mamba-7b depth sweep "
                         "(no contract line)")
    ap.add_argument("--label-sweep", action="store_true",
                    help="build, then only the label kernel's variants on "
                         "chains of 340-1040 nodes (no contract line)")
    ap.add_argument("--decode-sweep", action="store_true",
                    help="build, then only both decode kernels over 1-16 "
                         "query rows per kv head and 1-4 key splits (no "
                         "contract line)")
    ap.add_argument("--scan-sweep", action="store_true",
                    help="build, then only both RG-LRU entries over the "
                         "ring's tiles at recurrentgemma-2b's prefill shape "
                         "(no contract line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    phase_sass()
    if args.depth_sweep:
        depth_sweep()
        return 0
    if args.label_sweep:
        label_sweep()
        return 0
    if args.decode_sweep:
        decode_sweep()
        return 0
    if args.scan_sweep:
        scan_sweep()
        return 0
    rows = phase_kernels(Timer())
    log(f"[time] kernels done at {time.perf_counter() - t0:.1f} s")
    runs = phase_serve()
    log(f"[time] serve done at {time.perf_counter() - t0:.1f} s")
    runs.update(phase_fp32())
    log(f"[time] fp32 done at {time.perf_counter() - t0:.1f} s")
    runs.update(phase_search())
    log(f"[time] search done at {time.perf_counter() - t0:.1f} s")
    runs.update(phase_service())
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernel_line(rows, runs)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
