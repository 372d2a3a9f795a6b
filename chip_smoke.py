#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and the script exits
non-zero (no phase's failure is caught):

1. device: the card's name and power limit;
2. build: every ``src/repro_torch/csrc/*.cu`` (nine sources) compiled with
   nvcc for sm_90a, all at once; the SASS of the tensor-core flash prefill
   and backward must show every product as wgmma (HGMMA) at each head_dim
   and their loads as TMA;
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
   kernel, and G * Sq at R_MAX and R_MAX + 1), and at phi-3-vision's and
   qwen2-7b's decode both are timed; flash attention at the LayerNorm
   models' serve shapes, timed: stablelm-1.6b (MHA, D 64), starcoder2-3b
   (its decode on the split kernel at G 12) and whisper-small (the
   encoder's 1500 frames and the cross attention of 416 queries over them,
   both without a mask, and both decodes on the warp kernel), with small
   unmasked calls whose queries and keys differ in number; flash attention
   at the MoE models' serve shapes, timed: dbrx-132b's prefill (GQA 48:8)
   and decode (the warp kernel at G 6), llama4's prefill of 2 x 8200 with
   the 8192-position chunk mask and without it (GQA 40:8), its decode over
   the wrapped chunk buffer with key positions and over its global layer's
   8216 keys (the warp kernel at G 5), SDPA given the same chunk mask; the GA's group-label kernel (bit-equal to its plain version on
   mobilenet_v3, resnet50, a 1040-node chain with skips, each at 65536
   random genomes of fused-bit density 0.1 and 0.5 with an all-zero and an
   all-one row, on a graph too long for shared memory at 4096, and at the
   engine's batches: 64 genomes of mobilenet_v3, 128 of resnet50).  The
   kernels with variants (RMSNorm: ``vector``, ``generic``; group labels:
   ``warp``, ``block``, ``global``) must run the variant their plan picks,
   and every variant that can take a case is forced on it, checked and,
   where the case is timed, timed beside the others (and the group labels
   beside a bare launch).  Then the MoE dispatch at full width in fp32 (one
   dbrx-132b layer, one llama4 MoE layer, 1024 tokens at capacity factor
   1.25, picks dropped): the compact dispatch against the reference's
   slot-buffer algorithm, the kept picks equal and the outputs within
   1e-5, both timed, with its host synchronisations counted;
4. serve: chatglm3-6b, recurrentgemma-2b, falcon-mamba-7b,
   phi-3-vision-4.2b, qwen2-7b (GQA 28:4, QKV biases: its decode on the
   warp decode kernel at 7 query heads a kv head), and the LayerNorm
   models, which launch no RMSNorm: stablelm-1.6b, starcoder2-3b and
   whisper-small (1500 frame embeddings drawn from the same generator
   through a 12-layer encoder, once, in the prefill; 416 + 32 decoder
   positions; two flash calls a decoder layer and position, self and
   cross), and the MoE models (the MoE FFN is eager PyTorch, no counted
   kernel): dbrx-132b at 8 of its 40 layers (8 x 1024) and
   llama4-maverick-400b-a17b at 4 of its 48 (2 x 8200: the prompt crosses
   the 8192-position chunk boundary and the chunk buffers wrap at every
   decode step), at their published capacity factor, their kept and
   dropped picks logged for the prefill and the decode steps; each at its
   published widths and full depth (the MoE models at SERVE_LAYERS) in bf16,
   random weights from a seeded CUDA generator, 8 prompts and 32 greedy
   tokens through ``repro_torch.launch.serve.generate`` (recurrentgemma's
   prompt of 4096 tokens is twice its attention window, so the window cuts
   in during prefill and the rolling buffer wraps at the first decode step;
   phi-3-vision's 1024 text tokens follow 1024 image-patch embeddings drawn
   from the same generator); the launch counts of each run are checked
   exactly and its decode logits are held against one full forward;
   recurrentgemma-2b's run then profiles one prefill and one decode step
   (``torch.profiler``: device time by block, by kernel, and inside the
   RG-LRU blocks by op).  A MoE model's decode is held by ``routed_check``:
   with no drops (capacity factor E / K), the fp32 forward a layer at a
   time, and the floor rule over the positions whose picks agree with the
   fp32 reference's on both bf16 sides;
5. the same check in fp32 at full width with 2 or 3 layers (phi-3-vision
   with its 1024 image tokens, whisper-small with 2 encoder and 2 decoder
   layers over its 1500 frames, dbrx-132b at 2 layers, llama4 at 4 with 16
   of its 128 experts and a chunk of 64 positions, both MoE models with no
   drops; launch counts exact, every prefill attention on the SIMT kernel),
   and each reduced config's CUDA logits
   (forward and generate) against its plain CPU path (which the CPU tests
   hold against the JAX reference);
6. search: the paper's GA (mobilenet_v3 on simba, preset ``paper``, seed 0)
   and the random backend (resnet50 on eyeriss, 100000 evaluations) through
   ``repro_torch.search.SearchSession`` on the card; each must give the
   reference's genome, fitness and evaluation count exactly (GA_RUNS, held
   equal to the JAX package's by ``tests/test_torch_ga_search.py``), and
   every engine batch must have launched the label kernel once.  One line
   per run in ``BENCH_ga.json``'s record schema.  Then the same paper GA
   under the ``tpu`` cost model (the modelled TPU target's roofline; the
   label pass on the card), held to TPU_GA_RUN the same way, and one
   host-only TPU training-schedule search (``search_tpu_schedule``,
   qwen2-7b at ``train_4k``, the reference's defaults) held to
   TPU_SCHEDULE_RUN (both pinned to the JAX package's by
   ``tests/test_torch_tpu_costmodel.py``).

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
8. the daemon and the rest of the search side: ``ScheduleDaemon`` in this
   process on the card (``device=None``, two worker threads, 127.0.0.1:0,
   driven over HTTP): GA_RUNS' two searches at once on the two workers,
   each its golden result; a duplicate attached to the running job; a
   repeat served from the store with no search and no launch; a
   warm-started job whose first generation is at or above its cold twin's
   and the donor's; a 2-island job (ISLAND_RUNS, its spawned islands'
   engines ``cuda``); a long job cancelled while it runs; this process's
   label launches equal to the searched jobs' engine batches.  Then
   ``python -m repro_torch daemon`` in a subprocess, an island job
   submitted with ``jobs submit``, the daemon stopped mid-search and
   restarted on the same store, the journal's replay re-running the job to
   ISLAND_RUNS; ``store gc --max-objects 1`` (``--dry-run`` first) with a
   queued job pinning a key.  Last, in this process: ``analyze --json``
   (ANALYZE_GOLDEN), the spacemap GA and vgg16's per-region exhaustive run
   on the card (SPACEMAP_RUNS), ``export`` of mobilenet_v3 and ``search
   --workload file:...`` on the card (the zoo run's golden result and
   fingerprint, FILE_RUN), and ``verify`` of every artifact of the phase.
   Then ``repro_torch.ir.from_torch`` imports a small CNN module
   (``SmokeCNN``: depthwise, squeeze-excite, residual, concat, pooling) and
   its graph is searched on the card (FROM_TORCH_RUN: the fingerprint of
   ``from_jax`` on the same network written in JAX, and the reference's
   search result).  The goldens are the reference's, pinned by
   ``tests/test_torch_spacemap.py``, ``tests/test_torch_ir_passes.py`` and
   ``tests/test_torch_trace.py``.

9. training: the backward kernels against their plain versions on the card,
   in bf16 and fp32: flash attention's (dq, dk, dv, and the log-sum-exp its
   forward kernels write; within TOL) at qwen2-7b's 8 x 1024 (GQA 28:4, D
   128, causal), stablelm-1.6b's D 64 MHA, phi-3-vision's D 96 at 2048
   positions, recurrentgemma-2b's local attention (MQA 10:1, D 256, window
   2048 over 2 x 4096), whisper-small's 1500 x 1500 unmasked and 448 x 1500
   cross, chunk and window masks, ragged lengths, D 16 to 256 and G 1 to
   12, each case on the plan's kernel (``tc``, the tensor cores, for bf16 at
   D 64-256 with or without a window; else ``simt``) and on the other one
   forced where it takes the case, in bf16 each gradient also held row by
   row to FLASH_ROW_TOL; the first four shapes timed on each, with each
   launch of the call (delta, dK/dV, dQ) timed apart by CUDA events;
   RMSNorm's (dx, dw) at 8192 x 3584 and 8192 x 2048 and two small shapes,
   timed at qwen2-7b's
   rows; the gated RG-LRU's (dxa, dxi, dxc, db_a, db_i, dlambda, dh0; within
   TOL x RGLRU_TOL_MULT) at recurrentgemma-2b's 2 x 4096 by 2560 and ragged
   shapes with h0 and dh_last; the Mamba scan's (dda, ddbx, dc; within TOL)
   at falcon-mamba-7b's 8 x 1024 by 8192 x 16 and ragged shapes at N 4, 8
   and 16 (its fold, grads and dc launches timed apart at the first); each
   timed beside its bound, its plain version and a library call the port
   never calls where one computes the same function (SDPA's
   backward with the window as a mask, ``F.rms_norm``'s autograd backward;
   none for the scans); the ``simt`` backward also in fp32 at phase 5's
   fp32 prefill shapes, timed beside its fp32 bound and SDPA's fp32
   backward.  Then the slice's main paths (TRAIN_RUNS):
   ``make_train_step`` trains, at their published widths (bf16, AdamW
   with each config's moment dtype; lr and steps as TRAIN_RUNS says) from
   seeded random weights, qwen2-7b (8 of 28 layers, 8 x
   1024) under each ``remat`` policy (none, selective, full),
   recurrentgemma-2b (24 of 26 layers, 2 x 4096; all 26 under ``full``),
   falcon-mamba-7b (5 of 64 layers, 8 x 1024), chatglm3-6b (19 of 28, 8 x
   1024), stablelm-1.6b (24, 8 x 1024), starcoder2-3b (30, 8 x 1024),
   phi-3-vision-4.2b (32, 2 x (1024 image + 1024 text)), whisper-small (12
   + 12 over 1500 frames, 8 x 448), dbrx-132b (1 of 40, 8 x 1024) and
   llama4-maverick-400b-a17b (its first layer, chunked with a dense FFN, 2
   x 8200), each step's launches exact (``expected_train_launches``, by
   layer kind, the recomputed forwards counted; the attention forwards on
   ``tc_prefill`` with the log-sum-exp, the backwards on ``tc``, also for
   recurrentgemma-2b's window at D 256, whisper's encoder and cross
   attention and llama4's chunk mask), every parameter's gradient finite
   and non-zero, the loss finite and falling or flat; step ms, tokens/s,
   peak memory, the share of the step's FLOP bound and one profiled step
   (device ms by kernel, and the backward kernels' by launch).  Then
   falcon-mamba-7b's peak memory with ``DiscretiseBx`` and with the eager
   product it replaced, the bytes qwen2-7b's forward saves under each
   policy (``remat_costs``), the gradient checks (GRAD_CHECKS: the bf16
   kernel path's gradients against fp32 ones, leaf by leaf, within
   FLOOR_MULT times the bf16 plain path's distance; under ``remat`` too),
   qwen2-7b's three policies held to one another (``remat_compare``:
   first-step loss and gradients within the grad check's margin, bits
   reported, peaks falling none > selective > full), the reference's four
   training tests (``tests/test_system.py:54-99``) through ``train_loop``
   on the card, and the reduced recurrentgemma-2b and falcon-mamba-7b in
   fp32 on the card against the CPU's plain path and trained by
   ``train_loop``.

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
contract line.  ``--train-only`` runs phases 1-2 and then only phase 9; no
contract line.  ``--train-probe`` runs phases 1-2 and then only two
training steps of each TRAIN_PROBES config at two depths, printing the
peaks and the depth a line through them fits (how TRAIN_RUNS' depths were
placed); no contract line.  ``--rglru-ablate`` runs phases 1-2 and then only the gated
RG-LRU backward kernel's ablations (RGLRU_ABLATIONS: copies, chain, second
gate_math taken away) beside it, each built with ptxas's register and
spill report and timed in turns; no contract line.

Before the last line: one JSON line ``{"kernels": [...]}`` and the
``nvidia-smi`` name/power-limit line.  Last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import ctypes
import dataclasses
import hashlib
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
from torch import nn  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import DECODE_IMPLS  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.ops import _forward as flash_forward  # noqa: E402
from repro_torch.kernels.flash_attention.ops import plan as flash_plan  # noqa: E402
from repro_torch.kernels.flash_attention.ops import plan_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ga_labels.ops import ga_labels  # noqa: E402
from repro_torch.kernels.ga_labels.ops import card as ga_card  # noqa: E402
from repro_torch.kernels.ga_labels.ops import plan as ga_plan  # noqa: E402
from repro_torch.kernels.ga_labels.ops import variants as ga_variants  # noqa: E402
from repro_torch.kernels.ga_labels.ref import ga_labels_ref  # noqa: E402
from repro_torch.kernels.ga_labels.ref import label_tables  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_bwd  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_ref  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import VARIANTS as RGLRU_VARIANTS  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import plan as rglru_plan  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_gated, rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rglru_scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_gated_bwd  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import BWD_STEPS as RGLRU_BWD_STEPS  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_gated_bwd_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_gated_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_gates_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_states_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import plan as rms_plan  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import variants as rms_variants  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import TrainRunConfig, device_batch  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.moe import MoE, moe_slots_ref  # noqa: E402
from repro_torch.models.remat import POLICIES as REMAT_POLICIES  # noqa: E402
from repro_torch.models.moe import dispatch as moe_dispatch  # noqa: E402
from repro_torch.models.transformer import Transformer, loss_fn  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_update  # noqa: E402
from repro_torch.runtime import FaultInjector  # noqa: E402
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
          ("phi-3-vision-4.2b", 8, 1024, 32),
          ("qwen2-7b", 8, 1024, 32),
          ("stablelm-1.6b", 8, 1024, 32),
          ("starcoder2-3b", 8, 1024, 32),
          # 416 + 32 = 448 decoder positions, whisper's published context,
          # after the encoder's 1500 frames
          ("whisper-small", 8, 416, 32),
          ("dbrx-132b", 8, 1024, 32),
          # the prompt crosses llama4's 8192-position chunk boundary, and
          # the 8192-slot chunk buffers wrap at every decode step
          ("llama4-maverick-400b-a17b", 2, 8200, 32))
# the MoE models' depth on one 80 GB card (published widths; their bf16
# weights at full depth are ~264 and ~800 GB): dbrx-132b 8 of 40 layers
# (~55 GB), llama4 one period of its pattern, 4 of 48 (three chunked layers
# and a global one, layers 1 and 3 MoE: ~70 GB)
SERVE_LAYERS = {"dbrx-132b": 8, "llama4-maverick-400b-a17b": 4}
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
# the MoE dispatch at full width (``phase_moe``): tokens of one call
MOE_TOKENS = 1024
# phase 5's cuts of llama4 besides depth, to fit fp32 at 4 layers on one
# card (~28 GB): 16 routed experts, and a chunk of 64 positions, which the
# 128-token prompt crosses and the decode's buffers wrap
FP32_MOE_CUTS = {"llama4-maverick-400b-a17b": dict(n_experts=16,
                                                   attn_chunk=64)}
# fp32 (TF32 off): sums in another order only (~1e-6); bf16 arithmetic or
# TF32 would give >= 1e-3 and fail it.
SERVE_REL_TOL_FP32 = 1e-4
# the kernels' launch counters; the residual RMSNorm form is counted apart
COUNTERS = {"rmsnorm": fused_rmsnorm, "flash_attention": flash_attention,
            "rglru_scan": rglru_scan, "rglru_gated": rglru_gated,
            "mamba_scan": mamba_scan, "ga_labels": ga_labels,
            "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm_bwd": rmsnorm_bwd, "rglru_gated_bwd": rglru_gated_bwd,
            "mamba_scan_bwd": mamba_scan_bwd}
KERNELS = ("rmsnorm", "rmsnorm_residual", "flash_attention", "rglru_scan",
           "rglru_gated", "mamba_scan", "ga_labels", "flash_attention_bwd",
           "rmsnorm_bwd", "rglru_gated_bwd", "mamba_scan_bwd")
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


# phase 6: the paper's GA under the ``tpu`` cost model and the TPU
# training-schedule search, and the reference's results for them (``repro.
# search.search`` and ``repro.search.tpu.search_tpu_schedule`` with the same
# arguments; pinned equal to them by tests/test_torch_tpu_costmodel.py)
TPU_GA_RUN = dict(
    spec=dict(workload="mobilenet_v3", accelerator="simba", costmodel="tpu",
              backend="ga", backend_config={"preset": "paper"}, seed=0),
    golden=dict(genome_mask=0x1fd7fefefbf773feffe7affefdfd,
                best_fitness=5.867129250256347, evaluations=54009))
TPU_SCHEDULE_RUN = dict(
    arch="qwen2-7b", shape="train_4k",
    golden=dict(best=dict(remat="none", microbatches=1,
                          grad_compression=False, sharding="fsdp"),
                edp_improvement=1.0358422092053245,
                energy_j=14849.141844200652, evaluations=60,
                history_len=30))


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


def sdpa_call(q, k, v, causal, window, q_offset, kv_len, k_pos, chunk=0):
    """One ``scaled_dot_product_attention`` call computing what the flash
    kernel computes (the mask built beforehand, not timed)."""
    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not window and not chunk and k_pos is None:   # a prefix of the keys
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
    if chunk:
        mask &= kp // chunk == qp // chunk
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


def sass_of(lib: str) -> tuple:
    """The HGMMA lines of a built library's SASS (``cuobjdump -sass``), its
    count of HMMA (``mma.sync``) instructions and of TMA loads (UTMALDG)."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build._lib_path(lib))],
        capture_output=True, text=True, check=True).stdout
    return [line for line in sass.splitlines() if "HGMMA." in line], \
        sass.count(" HMMA."), sass.count("UTMALDG")


def phase_sass() -> None:
    """The tensor-core kernels' products are wgmma in the built code: the
    prefill's Q.K^T as HGMMA 64x64x16 from shared memory, its P.V as HGMMA
    64xDx16 with P in registers and V transposed (``tnspB``) at each
    head_dim; the backward's S^T, dP^T (and S, dP) as HGMMA 64x64x16 from
    shared memory, its dV, dK and dQ products as HGMMA 64xDx16 with the A
    operand in registers and dO, Q, K transposed, at head_dim 64, 96 and
    128 (at 256 each warpgroup takes its half's as 64x128x16); both fed by
    TMA loads (UTMALDG), and no product on the older tensor-core path
    (HMMA, ``mma.sync``)."""
    for lib, dims in (("flash_prefill_tc", (64, 96, 128, 256)),
                      ("flash_bwd_tc", (64, 96, 128))):
        hgmma, hmma, tma = sass_of(lib)
        ss = sum("HGMMA.64x64x16" in x and "tnspB" not in x for x in hgmma)
        rs = {d: sum(f"HGMMA.64x{d}x16" in x and "tnspB" in x
                     for x in hgmma) for d in dims}
        log(f"[sass] {lib}: {ss} HGMMA 64x64x16 from shared memory; by "
            f"head_dim {rs} HGMMA 64xDx16 (tnspB); {tma} UTMALDG; {hmma} "
            f"HMMA")
        if not ss or not all(rs.values()) or not tma or hmma:
            raise AssertionError(f"{lib}: a product is not wgmma or the "
                                 f"loads are not TMA")


def ran_variant(fn, before: dict) -> str:
    """The variant whose launch count moved since ``before``."""
    return next(v for v, c in fn.variant_launches.items() if c > before[v])


def kernels_rmsnorm(timer: Timer, rn) -> dict:
    """Both forms, both dtypes; serve shapes (the prefill rows, batch x
    (image + text positions), and the decode rows, batch, of each SERVES
    model with RMSNorm at its d_model: 4096, 2560, 3072, 3584 and 5120) + a
    ragged one.  Each case
    runs the variant ``plan`` picks (``vector`` at the serve shapes); every
    variant that takes it is forced and checked.  Timed in bf16 at the serve
    shapes, every variant (``ms``: the plan's), beside a device copy of the
    same bytes."""
    shapes = []
    for arch, batch, prompt, _ in SERVES:
        cfg = get_config(arch)
        if cfg.norm != "rmsnorm":          # LayerNorm: eager, no kernel
            continue
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
    and phase 5's fp32 prefill (1024 image + 128 text positions).  Then
    qwen2-7b's (D 128, GQA 28:4): its serve prefill, its decode at the
    first, a middle and the last step (1025, 1041 and 1055 keys: the warp
    kernel at 7 rows a kv head) and phase 5's fp32 prefill.  Last, decode
    cases for the warp kernel: G 1 at each head_dim, a wrapped
    rolling buffer with key positions, window, chunk, 2 and 8 queries, B 1
    with a long cache (many splits), a grid large enough for one split,
    and G 8 and 9 (R_MAX and R_MAX + 1 rows a kv head).  Then the
    LayerNorm models' serve shapes: stablelm-1.6b's prefill (MHA 32:32, D
    64) and decode (the warp kernel at G 1, one split), starcoder2-3b's
    (GQA 24:2, D 128; its decode on the split kernel at G 12), and
    whisper-small's: the encoder's 1500 frames without a mask (ragged:
    1500 = 23 x 64 + 28), the decoder's causal self-attention over 416
    tokens, its cross attention of 416 queries over the 1500 encoder
    states without a mask, and both at decode (the warp kernel over 417-447
    and over 1500 keys); phase 5's fp32 cross prefill (128 queries over
    1500 keys), and small ragged calls without a mask where queries and
    keys differ in number, on the tensor-core prefill.  Last, the MoE
    models' shapes (GQA 48:8 and 40:8, D 128): dbrx-132b's prefill (8 x
    1024, causal) and decode (the warp kernel at G 6 over 1041 keys);
    llama4's prefill of 2 x 8200 with the 8192-position chunk mask and
    without it (its global layer), its chunked decode over the wrapped
    8192-slot chunk buffer with key positions at position 8215, and its
    global decode over 8216 keys (the warp kernel at G 5); and phase 5's
    fp32 prefills of both (8 x 128, llama4's with its 64-position chunk)."""
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
    arch_q, B_q, P_q, N_q = SERVES[4]
    qw = get_config(arch_q)
    heads_q = (qw.n_heads, qw.n_kv_heads, qw.resolved_head_dim)
    last_q = P_q + N_q - 2                    # the last decode step's query
    lm = {}
    for arch, B_m, P_m, N_m in SERVES[5:]:
        c = get_config(arch)
        lm[arch] = (B_m, P_m, N_m, c.enc_seq,
                    (c.n_heads, c.n_kv_heads, c.resolved_head_dim))
    B_s, P_s, N_s, _, heads_s = lm["stablelm-1.6b"]
    B_c, P_c, N_c, _, heads_c = lm["starcoder2-3b"]
    B_w, P_w, N_w, T_w, heads_w = lm["whisper-small"]
    B_d, P_d, N_d, _, heads_d = lm["dbrx-132b"]
    B_l, P_l, N_l, _, heads_l = lm["llama4-maverick-400b-a17b"]
    C_l = get_config("llama4-maverick-400b-a17b").attn_chunk
    pos_l = P_l + 15                          # the 16th decode step: 8215
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
        ("prefill_qwen", (B_q, P_q, P_q) + heads_q, {}),
        ("decode_qwen", (B_q, 1, P_q + N_q) + heads_q,
         dict(q_offset=P_q + 16, kv_len=P_q + 17)),
        ("decode_qwen_first", (B_q, 1, P_q + N_q) + heads_q,
         dict(q_offset=P_q, kv_len=P_q + 1)),
        ("decode_qwen_last", (B_q, 1, P_q + N_q) + heads_q,
         dict(q_offset=last_q, kv_len=last_q + 1)),
        ("prefill_qwen_s128", (8, FP32_PROMPT, FP32_PROMPT) + heads_q, {}),
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
        ("prefill_stablelm", (B_s, P_s, P_s) + heads_s, {}),
        ("decode_stablelm", (B_s, 1, P_s + N_s) + heads_s,
         dict(q_offset=P_s + 16, kv_len=P_s + 17)),
        ("prefill_starcoder2", (B_c, P_c, P_c) + heads_c, {}),
        ("decode_starcoder2", (B_c, 1, P_c + N_c) + heads_c,
         dict(q_offset=P_c + 16, kv_len=P_c + 17)),
        ("prefill_whisper_encoder", (B_w, T_w, T_w) + heads_w,
         dict(causal=False)),
        ("prefill_whisper_self", (B_w, P_w, P_w) + heads_w, {}),
        ("prefill_whisper_cross", (B_w, P_w, T_w) + heads_w,
         dict(causal=False)),
        ("decode_whisper_self", (B_w, 1, P_w + N_w) + heads_w,
         dict(q_offset=P_w + 16, kv_len=P_w + 17)),
        ("decode_whisper_cross", (B_w, 1, T_w) + heads_w,
         dict(causal=False)),
        ("prefill_whisper_cross_s128", (B_w, FP32_PROMPT, T_w) + heads_w,
         dict(causal=False)),
        ("tc_d64_cross_ragged", (2, 100, 333, 4, 4, 64), dict(causal=False)),
        ("tc_d64_cross_few_keys", (1, 300, 70, 2, 2, 64),
         dict(causal=False)),
        ("tc_d128_cross_kv_len", (2, 130, 400, 4, 2, 128),
         dict(causal=False, kv_len=333)),
        ("prefill_dbrx", (B_d, P_d, P_d) + heads_d, {}),
        ("decode_dbrx", (B_d, 1, P_d + N_d) + heads_d,
         dict(q_offset=P_d + 16, kv_len=P_d + 17)),
        ("prefill_llama4_chunk", (B_l, P_l, P_l) + heads_l,
         dict(chunk=C_l)),
        ("prefill_llama4_global", (B_l, P_l, P_l) + heads_l, {}),
        ("decode_llama4_chunk", (B_l, 1, C_l) + heads_l,
         dict(q_offset=pos_l, kv_len=C_l, chunk=C_l,
              k_pos=rolling_kpos(pos_l, C_l))),
        ("decode_llama4_global", (B_l, 1, P_l + N_l) + heads_l,
         dict(q_offset=pos_l, kv_len=pos_l + 1)),
        # phase 5's fp32 prefills of the MoE models (llama4's chunk cut)
        ("prefill_dbrx_s128", (8, FP32_PROMPT, FP32_PROMPT) + heads_d, {}),
        ("prefill_llama4_s128_chunk", (8, FP32_PROMPT, FP32_PROMPT)
         + heads_l, dict(chunk=FP32_MOE_CUTS[
             "llama4-maverick-400b-a17b"]["attn_chunk"])),
    ]


# the timed cases, each with the kernel it must run: the bf16 serve shapes
# and, in fp32, phase 5's prefills on the SIMT kernel
FLASH_TIMED = {torch.bfloat16: {"prefill": "tc_prefill",
                                "decode": "split_decode",
                                "prefill_d256_window": "tc_prefill",
                                "decode_d256_rolling": "split_decode",
                                "prefill_d96": "tc_prefill",
                                "decode_d96": "warp_decode",
                                "prefill_qwen": "tc_prefill",
                                "decode_qwen": "warp_decode",
                                "prefill_stablelm": "tc_prefill",
                                "decode_stablelm": "warp_decode",
                                "prefill_starcoder2": "tc_prefill",
                                "decode_starcoder2": "split_decode",
                                "prefill_whisper_encoder": "tc_prefill",
                                "prefill_whisper_self": "tc_prefill",
                                "prefill_whisper_cross": "tc_prefill",
                                "decode_whisper_self": "warp_decode",
                                "decode_whisper_cross": "warp_decode",
                                "prefill_dbrx": "tc_prefill",
                                "decode_dbrx": "warp_decode",
                                "prefill_llama4_chunk": "tc_prefill",
                                "prefill_llama4_global": "tc_prefill",
                                "decode_llama4_chunk": "warp_decode",
                                "decode_llama4_global": "warp_decode"},
               torch.float32: {"prefill_s128": "simt",
                               "prefill_d256_s128_window": "simt",
                               "prefill_d96_s1152": "simt",
                               "prefill_qwen_s128": "simt",
                               "prefill_whisper_encoder": "simt",
                               "prefill_whisper_cross_s128": "simt",
                               "prefill_dbrx_s128": "simt",
                               "prefill_llama4_s128_chunk": "simt"}}


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
    phi-3-vision's and qwen2-7b's decode the forced split kernel beside the
    warp kernel, in turns.  At each timed decode the plain version without the newest
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
                if kw.get("chunk") and "k_pos" in kw:
                    # a wrapped chunk buffer's last slot holds a key of the
                    # previous chunk, masked anyway: drop the newest key by
                    # its position instead
                    kp = kw["k_pos"].clone()
                    kp[kp == kw["q_offset"]] = -1
                    short = dict(kw, k_pos=kp)
                miss = row_scaled_err(attention_ref(q, k, v, **short), ref)
                if not miss > FLASH_ROW_TOL[dt]:
                    raise AssertionError(f"flash {name}: dropping the newest "
                                         f"key moves the output {miss:.3e} "
                                         f"of the rows' scale, within the "
                                         f"tolerance")
                case["newest_key_dropped_row_scaled_err"] = miss
            if serve:
                lib = sdpa_call(q, k, v, kw.get("causal", True),
                                kw.get("window", 0),
                                kw.get("q_offset", 0), kw.get("kv_len"),
                                kw.get("k_pos"), kw.get("chunk", 0))
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
            # the plain version of llama4's 2 x 8200 prefill holds two 20 GiB
            # score tensors: return the cached blocks, unsplit
            torch.cuda.empty_cache()
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


def sync_round_trip_us(reps: int = 50) -> float:
    """Median host microseconds of what the compact MoE dispatch adds a
    call: a launch, then a device-to-host read of a few ints that waits
    for it, from an idle card."""
    t = torch.zeros(16, dtype=torch.long, device=DEV)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.add_(1).tolist()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def phase_moe(timer: Timer) -> None:
    """The MoE dispatch at full width, in fp32: one dbrx-132b layer (d 6144,
    16 experts top-4) and one llama4 MoE layer (d 5120, 128 experts top-1
    and the shared expert; 65 GB), MOE_TOKENS tokens at the published
    capacity factor 1.25, so picks are dropped.  The compact dispatch (the
    model's ``MoE``) against its plain version, the reference's slot-buffer
    algorithm (``moe_slots_ref``): the kept picks equal, the outputs within
    1e-5 (abs + rel), the aux loss within 1e-6.  Both timed (``Timer``; the
    compact form's host synchronisation and the launches after it inside
    its time), its synchronisations a call counted, and a bare round trip
    (``sync_round_trip_us``) timed."""
    log(f"[moe] {json.dumps({'sync_round_trip_us': sync_round_trip_us()})}")
    for arch in ("dbrx-132b", "llama4-maverick-400b-a17b"):
        cfg = dataclasses.replace(get_config(arch), param_dtype="float32")
        g = torch.Generator(device=DEV).manual_seed(5)
        moe = MoE(cfg, torch.float32, DEV, g)
        x = torch.randn(1, MOE_TOKENS, cfg.d_model, generator=g, device=DEV)
        before = (moe_dispatch.kept, moe_dispatch.dropped,
                  moe_dispatch.host_syncs)
        y, aux = moe(x)
        kept, dropped, syncs = (now - then for now, then in zip(
            (moe_dispatch.kept, moe_dispatch.dropped,
             moe_dispatch.host_syncs), before))
        x2 = x.reshape(MOE_TOKENS, cfg.d_model)
        _, gate, sel = moe.route(x2)
        picks = moe_dispatch(x2, gate, sel, moe.w_gate, moe.w_up,
                             moe.w_down, moe.capacity(MOE_TOKENS))[1]
        y_ref, aux_ref, picks_ref = moe_slots_ref(moe, x)
        if not torch.equal(picks, picks_ref):
            raise AssertionError(f"moe {arch}: the compact dispatch keeps "
                                 f"other picks than the slot buffer")
        err = close(y, y_ref, 1e-5)
        if not abs(aux.item() - aux_ref.item()) <= 1e-6:
            raise AssertionError(f"moe {arch}: aux {aux.item()} vs "
                                 f"{aux_ref.item()}")
        active = int((torch.bincount(sel.reshape(-1),
                                     minlength=cfg.n_experts) > 0).sum())
        row = {"arch": arch, "d_model": cfg.d_model,
               "experts": cfg.n_experts, "top_k": cfg.top_k,
               "shared": cfg.n_shared_experts, "tokens": MOE_TOKENS,
               "dtype": "float32", "capacity_factor": cfg.capacity_factor,
               "capacity": moe.capacity(MOE_TOKENS), "kept": kept,
               "dropped": dropped, "experts_with_rows": active,
               "picks_equal": True, "tol": 1e-5, "max_abs_err": err,
               "host_syncs_per_call": syncs,
               "ms": timer.ms(lambda: moe(x)),
               "plain_ms": timer.ms(lambda: moe_slots_ref(moe, x))}
        log(f"[moe] {json.dumps(row)}")
        del moe, x, x2, y, y_ref, gate, sel, picks, picks_ref
        torch.cuda.empty_cache()


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in fp64, 2^24 elements at a time (a billion-element
    expert leaf would take 25 GB at once)."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, b.numel(), 1 << 24):
        x, y = a[i:i + (1 << 24)].double(), b[i:i + (1 << 24)].double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / den) ** 0.5 if den else float("inf")


def reset_counts() -> None:
    for f in COUNTERS.values():
        f.launches = 0
    fused_rmsnorm.residual_launches = 0
    fused_rmsnorm.variant_launches = dict.fromkeys(
        fused_rmsnorm.variant_launches, 0)
    flash_attention.impl_launches = dict.fromkeys(
        flash_attention.impl_launches, 0)
    flash_attention.lse_launches = 0
    flash_attention_bwd.impl_launches = dict.fromkeys(
        flash_attention_bwd.impl_launches, 0)
    ga_labels.variant_launches = dict.fromkeys(ga_labels.variant_launches, 0)
    rglru_scan.variant_launches = dict.fromkeys(rglru_scan.variant_launches,
                                                0)


def read_counts() -> dict:
    counts = {name: f.launches for name, f in COUNTERS.items()}
    counts["rmsnorm_residual"] = fused_rmsnorm.residual_launches
    counts["rmsnorm"] -= counts["rmsnorm_residual"]
    return {k: counts[k] for k in KERNELS}


def flash_calls(cfg, new: int) -> tuple:
    """(prefill, decode) flash calls of ``generate``: a position runs each
    attention layer once, an ``is_encdec`` decoder layer twice (self and
    cross attention); whisper's encoder layers run once, in the prefill."""
    attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    if cfg.is_encdec:
        return cfg.n_enc_layers + 2 * attn, 2 * attn * (new - 1)
    return attn, attn * (new - 1)


def expected_launches(cfg, new: int) -> dict:
    """What ``generate`` launches: one prefill and new - 1 decode steps run
    every norm (two a layer outside the ssm family, one inside, plus the
    final one) on RMSNorm's kernel, unless the config's norm is LayerNorm
    (eager, no kernel), every attention call (``flash_calls``) and every
    RG-LRU layer (the gated kernel, prefill and decode step alike); the
    Mamba scan runs in the prefill only (its decode step is plain torch
    ops); neither the residual form nor the RG-LRU interface entry is on
    the path."""
    kinds = cfg.layer_kinds()
    norms = len(kinds) * (1 if cfg.family == "ssm" else 2) + 1
    if cfg.norm != "rmsnorm":
        norms = 0
    return {"rmsnorm": norms * new, "rmsnorm_residual": 0,
            "flash_attention": sum(flash_calls(cfg, new)),
            "rglru_scan": 0, "rglru_gated": kinds.count("rglru") * new,
            "mamba_scan": kinds.count("mamba"), "ga_labels": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
            "rglru_gated_bwd": 0, "mamba_scan_bwd": 0}


def expected_flash_impls(cfg, new: int) -> dict:
    """Which flash kernel ``generate`` runs: every prefill call on the
    tensor cores in bf16, on the SIMT kernel in fp32; the new - 1 decode
    steps' calls (one query a sequence; cross attention's too) on the
    decode kernel the plan picks for the config's heads: ``warp_decode``
    at up to R_MAX query heads per kv head, else ``split_decode``."""
    prefill, decode = flash_calls(cfg, new)
    bf16 = cfg.param_dtype == "bfloat16"
    impls = dict.fromkeys(flash_attention.impl_launches, 0)
    if prefill:
        how = flash_plan(1, 1, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim,
                         torch.bfloat16 if bf16 else torch.float32, 1)
        impls[how.impl] = decode
        impls["tc_prefill" if bf16 else "simt"] = prefill
    return impls


def check_launches(cfg, new: int, res: dict) -> None:
    """A serve run's launch counts must be exactly as expected, and so must
    the flash kernel each attention call went to; every RMSNorm runs its
    ``vector`` variant (a LayerNorm model runs none)."""
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
    for key, kind in (("dkdv_kernel<", "flash_attention_bwd"),
                      ("dq_kernel<", "flash_attention_bwd"),
                      ("dkdv_tc_kernel<", "flash_attention_bwd"),
                      ("dq_tc_kernel<", "flash_attention_bwd"),
                      ("_tc_wide_kernel", "flash_attention_bwd"),
                      ("delta_kernel<", "flash_attention_bwd"),
                      ("rmsnorm_bwd", "rmsnorm_bwd"),
                      ("rmsnorm_dw", "rmsnorm_bwd"),
                      ("rg_bwd<", "rglru_gated_bwd"),
                      ("mb_fold<", "mamba_scan_bwd"),
                      ("mb_grads<", "mamba_scan_bwd"),
                      ("mb_dc", "mamba_scan_bwd"),
                      ("gated<", "rglru_gated"), ("direct<", "rglru_scan"),
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


# the backward kernels in a profiler's events (``launch_split``)
BWD_KINDS = ("flash_attention_bwd", "rglru_gated_bwd", "mamba_scan_bwd")


def launch_split(events) -> dict:
    """{launch: [launches, device ms]} of the backward kernels in a
    profiler's events, a launch named by its kernel and template arguments
    (``delta_kernel<__nv_bfloat16>``, ``dkdv_tc_kernel<128>``,
    ``mb_grads<float, 16>``)."""
    from torch.autograd import DeviceType
    out = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and \
                kernel_kind(e.name) in BWD_KINDS:
            n = e.name.replace("(anonymous namespace)::", "")
            k = out.setdefault(n.removeprefix("void ").split("(")[0],
                               [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    return out


def launch_times(timer: Timer, fn, names: tuple, reps: int = 10) -> dict:
    """Each launch of one backward call apart: ``fn(marks)`` records the
    len(names) + 1 CUDA events ``marks`` at its launches' boundaries (the
    C entries' ``marks``); the median over ``reps`` calls of each launch's
    ms, the L2 flushed and the stream held by a sleep kernel before each
    call, as ``Timer``.  (CUDA events and not the profiler: minutes into a
    run the profiler dropped a short window's device events.)"""
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(names) + 1)]
    for m in marks:
        m.record()   # creates the event
    fn(marks)
    times = {n: [] for n in names}
    for _ in range(reps):
        timer.flush.zero_()
        torch.cuda._sleep(2_000_000)
        fn(marks)
        marks[-1].synchronize()
        for i, n in enumerate(names):
            times[n].append(marks[i].elapsed_time(marks[i + 1]))
    return {n: statistics.median(t) for n, t in times.items()}


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


class RouteLog:
    """Forward hooks on a model's MoE layers: the kept and dropped picks of
    its calls, the prefill's (more than one token a sequence) apart from the
    decode steps', from the dispatch's counters; with ``record``, each
    layer's picks (B, S, K) at each call, recomputed from the layer's input
    (the router is deterministic).  ``close`` removes the hooks."""

    def __init__(self, model, record: bool = False):
        self.moes = [m for m in model.modules() if isinstance(m, MoE)]
        self.record = record
        self.sel = [[] for _ in self.moes]
        self.picks = {ph: {"kept": 0, "dropped": 0, "host_syncs": 0}
                      for ph in ("prefill", "decode")}
        self.hooks = [h for i, m in enumerate(self.moes) for h in (
            m.register_forward_pre_hook(self._before),
            m.register_forward_hook(
                lambda mod, args, out, i=i: self._after(i, mod, args)))]

    @staticmethod
    def _counts() -> tuple:
        return moe_dispatch.kept, moe_dispatch.dropped, moe_dispatch.host_syncs

    def _before(self, mod, args) -> None:
        self.start = self._counts()

    def _after(self, i, mod, args) -> None:
        x = args[0]
        B, S, D = x.shape
        tally = self.picks["decode" if S == 1 else "prefill"]
        for key, now, then in zip(("kept", "dropped", "host_syncs"),
                                  self._counts(), self.start):
            tally[key] += now - then
        if self.record:
            self.sel[i].append(mod.route(x.reshape(B * S, D))[2]
                               .view(B, S, -1).sort(-1).values)

    def close(self) -> None:
        for h in self.hooks:
            h.remove()


@contextlib.contextmanager
def fp32_params(module):
    """Inside: the module's parameters as fp32 copies, the originals back
    after (bf16 -> fp32 -> bf16 is exact); 3-D parameters (a MoE layer's
    expert stacks) stay as they are, and ``models.moe.expert`` casts them
    an expert at a time."""
    saved = [(p, p.data) for p in module.parameters()
             if p.dim() < 3 and p.dtype != torch.float32]
    for p, data in saved:
        p.data = data.float()
    try:
        yield
    finally:
        for p, data in saved:
            p.data = data


def forward_fp32_by_layer(model, tokens, last: int) -> torch.Tensor:
    """``model(tokens, last=last)`` in fp32 arithmetic on a bf16 model's
    weights, with no fp32 copy of the model (dbrx-132b's 8 layers would take
    104 GB, llama4's 4 layers 140 GB): each layer's parameters in fp32 for
    its own pass only, the experts cast one at a time, the unembedding in
    blocks of 32768 columns.  For configs without image tokens or frames
    (the MoE models)."""
    x = F.embedding(tokens, model.embed).float()
    for layer in model.layers:
        with fp32_params(layer):
            x = layer(x)
    x = x[:, -last:].contiguous()
    with fp32_params(model.final_norm):
        x = model.final_norm(x)
    w = model.embed.t() if model.cfg.tie_embeddings else model.unembed
    return torch.cat([x @ w[:, i:i + 32768].float()
                      for i in range(0, w.shape[1], 32768)], -1)


def routed_check(model, prompts, new: int) -> dict:
    """The bf16 decode-vs-forward check of a MoE model.  Capacity depends
    on the tokens of a call (a decode step routes B tokens, the forward B x
    positions), so it runs on the same weights with no drops (capacity
    factor E / K: capacity >= N), its own ``generate`` beside the timed one;
    the fp32 forward goes a layer at a time (``forward_fp32_by_layer``).  A
    token whose k-th and (k+1)-th router probabilities are closer than
    bf16's rounding picks another expert, which moves its logits by order 1:
    the floor rule (FLOOR_MULT, unchanged) is applied over the positions
    whose picks, in every MoE layer, agree with the fp32 reference's on both
    bf16 sides, the decode and the forward; the rest are counted and left
    out.  A wrong cache slot, key position or chunk buffer still moves every
    remaining position by order 1."""
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    capacity = [m.capacity_factor for m in moes]
    logs = []

    def logged(fn):
        log_ = RouteLog(model, record=True)
        try:
            return fn()
        finally:
            log_.close()
            logs.append(log_)

    for m in moes:
        m.capacity_factor = m.n_experts / m.top_k
    try:
        out = logged(lambda: generate(model, prompts, new))
        full = torch.cat([prompts, out.tokens[:, :-1]], 1)
        ref = logged(lambda: model(full, last=new))
        ref32 = logged(lambda: forward_fp32_by_layer(model, full, new))
    finally:
        for m, cf in zip(moes, capacity):
            m.capacity_factor = cf
    # each side's picks at the positions whose logits are compared (the
    # prompt's last, then the decode steps'): (layers, B, new, K)
    dec = torch.stack([torch.cat([sel[0][:, -1:]] + sel[1:], 1)
                       for sel in logs[0].sel])
    fwd, f32 = (torch.stack([sel[0][:, -new:] for sel in log_.sel])
                for log_ in logs[1:])
    agree_dec = (dec == f32).all(-1).all(0)          # (B, new)
    agree_fwd = (fwd == f32).all(-1).all(0)
    keep = agree_dec & agree_fwd
    if not keep.any():
        raise AssertionError("routed check: no position's picks agree with "
                             "the fp32 reference's on both sides")
    floor = rel_rms(ref[keep], ref32[keep])
    err = rel_rms(out.logits, ref)
    agree = (out.logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    return {"capacity_factor": "E / K (no drops)",
            "logits_rel_rms_vs_forward": err,
            "logits_max_abs_diff": (out.logits - ref).abs().max().item(),
            "argmax_agreement": agree,
            "positions": keep.numel(),
            "positions_checked": int(keep.sum()),
            "positions_left_out": int((~keep).sum()),
            "positions_flipped_decode": int((~agree_dec).sum()),
            "positions_flipped_forward": int((~agree_fwd).sum()),
            "decode_rel_rms_vs_fp32_forward": rel_rms(out.logits[keep],
                                                      ref32[keep]),
            "bf16_forward_rel_rms_vs_fp32_forward": floor,
            "limit": FLOOR_MULT * floor}


def serve_check(cfg, batch, prompt, new, label, warm=False, profile=False,
                cuts=None):
    """generate() then one forward over prompt + generated tokens; the
    decode logits must match the forward's at the same positions (only
    those are unembedded: recurrentgemma-2b's (8, 4127, 256000) fp32 logits
    would take 34 GB): in fp32 within SERVE_REL_TOL_FP32, in bf16 within the
    rounding floor (FLOOR_MULT), for which the model is then cast to fp32;
    a bf16 MoE model is held by ``routed_check`` instead.  A MoE model's
    kept and dropped picks of the counted run are logged (``moe_picks``:
    the prefill's and the decode steps'), as are ``cuts``, what the run cut
    from the published config.  ``profile``: after the counted run,
    ``layer_profile`` of a prefill and a decode step."""
    g = torch.Generator(device=DEV).manual_seed(0)
    model = Transformer(cfg, DEV, generator=g)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=DEV)
    img = frames = None
    if cfg.img_tokens:            # as serve.main draws them
        img = torch.randn(batch, cfg.img_tokens, cfg.d_model, generator=g,
                          device=DEV).to(model.dtype)
    if cfg.is_encdec:             # likewise
        frames = torch.randn(batch, cfg.enc_seq, cfg.d_model, generator=g,
                             device=DEV).to(model.dtype)
    if warm:                      # cuBLAS handles, allocator: not timed
        generate(model, prompts[:, :16], 2,
                 None if img is None else img[:, :16], frames)
    torch.cuda.reset_peak_memory_stats()
    routes = RouteLog(model) if cfg.n_experts else None
    reset_counts()
    out = generate(model, prompts, new, img, frames)
    launches = read_counts()
    if routes is not None:
        routes.close()
    flash_impls = dict(flash_attention.impl_launches)
    norm_variants = dict(fused_rmsnorm.variant_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = layer_profile(model, prompts, img, new) if profile else None
    if out.tokens.shape != (batch, new) or out.logits.shape != (
            batch, new, cfg.vocab) or not torch.isfinite(out.logits).all():
        raise AssertionError(f"{label}: bad generate output")
    bf16 = cfg.param_dtype == "bfloat16"
    if bf16 and cfg.n_experts:
        check = routed_check(model, prompts, new)
    else:
        full = torch.cat([prompts, out.tokens[:, :-1]], 1)
        ref = model(full, last=new, img_embeds=img, frames=frames)
        check = {"logits_rel_rms_vs_forward": rel_rms(out.logits, ref),
                 "logits_max_abs_diff": (out.logits - ref).abs().max().item(),
                 "argmax_agreement": (out.logits.argmax(-1)
                                      == ref.argmax(-1)).float().mean().item()}
        if bf16:                  # the same weights in fp32 arithmetic
            ref32 = model.float()(full, last=new, img_embeds=img,
                                  frames=frames)
            floor = rel_rms(ref, ref32)
            check.update(decode_rel_rms_vs_fp32_forward=rel_rms(out.logits,
                                                                ref32),
                         bf16_forward_rel_rms_vs_fp32_forward=floor,
                         limit=FLOOR_MULT * floor)
            del ref32
        else:
            check["limit"] = SERVE_REL_TOL_FP32
        del ref, full
    # the whole check's peak: the forward's activations and, in bf16, the
    # weights' fp32 copy (qwen2-7b's ~30 GB) or a MoE model's layer-by-layer
    # fp32 pass
    check["check_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": batch, "prompt": prompt, "img_tokens": cfg.img_tokens,
           "enc_frames": 0 if frames is None else frames.shape[1],
           "tokens": new,
           "prefill_ms": out.prefill_s * 1e3,
           "decode_ms_per_step": out.decode_s * 1e3 / max(new - 1, 1),
           "decode_tok_per_s": batch * (new - 1) / out.decode_s,
           "peak_mem_gb": peak_gb, "launches": launches,
           "flash_impls": flash_impls, "rmsnorm_variants": norm_variants,
           **check}
    if routes is not None:
        res["moe_picks"] = routes.picks
        res["capacity_factor"] = cfg.capacity_factor
    if cuts:
        res["cuts"] = cuts
    if prof is not None:
        res["profile"] = prof
    log(f"[serve] {label} {json.dumps(res)}")
    checked = check["decode_rel_rms_vs_fp32_forward" if bf16
                    else "logits_rel_rms_vs_forward"]
    if not checked <= check["limit"]:
        raise AssertionError(f"{label}: decode logits relative RMS error "
                             f"{checked:.3e} > {check['limit']:.3e}")
    del model, out, prompts, img, frames
    torch.cuda.empty_cache()
    return res


def serve_config(arch: str) -> tuple:
    """(phase 4's config of ``arch``, what it cuts from the published one):
    the MoE models at their SERVE_LAYERS depth."""
    cfg = get_config(arch)
    if arch not in SERVE_LAYERS:
        return cfg, None
    cuts = {"n_layers": [cfg.n_layers, SERVE_LAYERS[arch]]}
    return dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch]), cuts


def phase_serve() -> dict:
    """Each model in turn (the previous one freed), counts set to 0 just
    before its run and read just after (``check_launches``)."""
    runs = {}
    for arch, batch, prompt, new in SERVES:
        cfg, cuts = serve_config(arch)
        res = serve_check(cfg, batch, prompt, new, f"bf16 full {arch}",
                          warm=True, profile=arch == "recurrentgemma-2b",
                          cuts=cuts)
        check_launches(cfg, new, res)
        runs[arch] = res
    return runs


def phase_fp32() -> dict:
    """Phase 5; returns its full-width runs by label, counted as phase 4's
    are (their prefills are where the SIMT kernel runs on a model path)."""
    runs = {}
    for arch, layers in (("chatglm3-6b", 2), ("recurrentgemma-2b", 3),
                         ("falcon-mamba-7b", 2), ("phi-3-vision-4.2b", 2),
                         ("qwen2-7b", 2), ("stablelm-1.6b", 2),
                         ("starcoder2-3b", 2), ("whisper-small", 2),
                         ("dbrx-132b", 2), ("llama4-maverick-400b-a17b", 4)):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers,
                                  param_dtype="float32")
        cuts = None
        if cfg.is_encdec:         # as many encoder layers
            cfg = dataclasses.replace(cfg, n_enc_layers=layers)
        if cfg.n_experts:
            cuts = dict(FP32_MOE_CUTS.get(arch, {}))
            cfg = dataclasses.replace(cfg, **cuts)
            # no drops: cap >= N, so decode and forward route alike
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            cuts = {k: [getattr(full, k), v] for k, v in dict(
                cuts, n_layers=layers,
                capacity_factor=cfg.capacity_factor).items()}
        label = f"fp32 {layers}-layer {arch}"
        res = serve_check(cfg, 8, FP32_PROMPT, 8, label, cuts=cuts)
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
        frames = (torch.randn(2, small.enc_seq, small.d_model, generator=g)
                  if small.is_encdec else None)
        img_dev = None if img is None else img.to(DEV)
        frames_dev = None if frames is None else frames.to(DEV)
        err = close(gpu(toks.to(DEV), img_embeds=img_dev,
                        frames=frames_dev).cpu(),
                    cpu(toks, img_embeds=img, frames=frames), 1e-4)
        gen_gpu = generate(gpu, toks[:, :21].to(DEV), 6, img_dev, frames_dev)
        gen_cpu = generate(cpu, toks[:, :21], 6, img, frames)
        err_gen = close(gen_gpu.logits.cpu(), gen_cpu.logits, 1e-4)
        log(f"[serve] reduced {small.name} cuda vs cpu plain path: max abs "
            f"err forward {err:.3e}, generate {err_gen:.3e} (tol 1e-4 abs + "
            f"rel: fp32, sums in another order)")
    return runs


def phase_search() -> dict:
    """Each GA_RUNS search and TPU_GA_RUN through a ``SearchSession`` on the
    card, counts set to 0 just before it and read just after: the
    reference's genome, fitness and evaluations exactly; one label-kernel
    launch per engine batch, through the ``warp`` variant, and no other
    kernel.  Then ``tpu_schedule_run``."""
    runs = {}
    for label, run in {**GA_RUNS, "tpu_ga": TPU_GA_RUN}.items():
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
    runs["tpu_schedule"] = tpu_schedule_run()
    return runs


def tpu_schedule_run() -> dict:
    """``search_tpu_schedule`` (the GA over remat x microbatches x gradient
    compression x sharding of a training step on the modelled TPU target)
    for TPU_SCHEDULE_RUN's cell with the reference's defaults: host-only,
    so no kernel may launch; held to TPU_SCHEDULE_RUN exactly."""
    from repro_torch.configs import SHAPES
    from repro_torch.search.tpu import search_tpu_schedule
    run = TPU_SCHEDULE_RUN
    reset_counts()
    t0 = time.perf_counter()
    res = search_tpu_schedule(get_config(run["arch"]), SHAPES[run["shape"]])
    wall = time.perf_counter() - t0
    launches = read_counts()
    got = dict(best=dataclasses.asdict(res.best),
               edp_improvement=res.edp_improvement,
               energy_j=res.best_cost.energy_j,
               evaluations=res.evaluations, history_len=len(res.history))
    out = {"name": "tpu_schedule", "arch": run["arch"],
           "shape": run["shape"], **got, "wall_s": wall,
           "launches": launches}
    log(f"[search] {json.dumps(out)}")
    if got != run["golden"] or any(launches.values()):
        raise AssertionError(f"tpu_schedule: {got}, launches {launches} != "
                             f"reference {run['golden']}, none")
    return out


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


def cli(*argv, env=None, cwd=None) -> tuple:
    """``python -m repro_torch <argv>`` in the service directory (or
    ``cwd``): (stdout, seconds); a failure shows its output."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", *argv],
        cwd=cwd or SERVICE_DIR,
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


# ---- phase 8: the daemon and the rest of the search side ----------------------------

# the spacemap runs and the reference's results for them (``repro.search.
# search`` with the same arguments; pinned by tests/test_torch_spacemap.py):
# the paper GA over the spacemap-reduced genome, and vgg16's 2^21 space
# solved exactly by per-region composition (scored one genome at a time,
# off the population engine)
SPACEMAP_RUNS = {
    "spacemap_ga": dict(
        spec=dict(workload="mobilenet_v3", accelerator="simba", backend="ga",
                  backend_config={"preset": "paper"}, seed=0, spacemap=True),
        golden=dict(genome_mask=0x15a4a934ac4f175acdd2749a5cdf,
                    best_fitness=1.5828072147849952, evaluations=56675)),
    "per_region": dict(
        spec=dict(workload="vgg16", accelerator="simba",
                  backend="exhaustive", spacemap=True),
        golden=dict(genome_mask=0x1a4225, best_fitness=1.0273429656033972,
                    evaluations=37)),
}
# ``analyze mobilenet_v3 --accel simba --json``: the sha256 of the
# reference's document (pinned by tests/test_torch_spacemap.py)
ANALYZE_GOLDEN = dict(
    workload="mobilenet_v3", accelerator="simba", frozen=9, regions=2,
    sha256="36415d8ab5eea3956345700cf37a5845f3df65cd4627ec7cfe83a036fb522c5d")
# the ``file:`` run: mobilenet_v3 exported, then searched with GA_RUNS'
# paper GA spec; the zoo graph's fingerprint (the reference's; pinned by
# tests/test_torch_ir_passes.py) and the zoo run's golden result
FILE_RUN = dict(run="paper_ga", fingerprint="ir1:719ccbccc569d369a2b038f57"
                                            "f36495f3af40bdfc4bc17c4b38c479"
                                            "98bb090d9")
# the warm-started job (and its cold twin, run directly): a fast GA on the
# paper GA's graph, so the store's paper GA winner is its exact donor
WARM_SPEC = dict(workload="mobilenet_v3", accelerator="simba", backend="ga",
                 seed=7, backend_config={"preset": "fast", "generations": 10})
# the job the daemon is stopped under, and re-runs after its restart:
# ISLAND_RUNS' 2-island run (its spawned islands take seconds to start, so
# the stop lands mid-search)
RESTART_SPEC = dict(ISLAND_SPEC, backend_config=island_config(2))
RESTART_GOLDEN = ISLAND_RUNS[2]
# the job cancelled while it runs
LONG_SPEC = dict(workload="unet", backend="ga",
                 backend_config={"preset": "fast", "generations": 100000})
DAEMON_DIR = ROOT / "build" / "schedule_daemon"
TERMINAL = ("done", "failed", "cancelled")
# the commands' device flags: none on the card (their default); a dry run
# of phase 8's logic on the CPU sets DEV = "cpu" and these to
# ["--device", "cpu"]
DEVICE_ARGS: list = []


def engine_name() -> str:
    """The population engine's name in artifacts: ``cuda`` on the card."""
    return "cuda" if DEV == "cuda" else "torch"


def label_launches_for(batches: int) -> int:
    """What the label kernel's counter must show for ``batches`` engine
    batches: one launch each on the card, none on the CPU."""
    return batches if DEV == "cuda" else 0


def http(method: str, url: str, payload=None):
    import urllib.request
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def wait_job(base: str, jid: int, timeout: float = 300.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        j = http("GET", f"{base}/jobs/{jid}")
        if j["state"] in TERMINAL:
            if j["state"] == "failed":
                raise AssertionError(f"daemon job {jid} failed: {j}")
            return j
        if time.monotonic() > deadline:
            raise AssertionError(f"daemon job {jid} stuck: {j['state']}")
        time.sleep(0.05)


def wait_running(base: str, jid: int, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while http("GET", f"{base}/jobs/{jid}")["state"] != "running":
        if time.monotonic() > deadline:
            raise AssertionError(f"daemon job {jid} never started")
        time.sleep(0.02)


def golden_of(art) -> dict:
    return dict(genome_mask=art.genome_mask, best_fitness=art.best_fitness,
                evaluations=art.evaluations)


def island_golden_of(art) -> dict:
    return dict(genome_mask=art.genome_mask, best_fitness=art.best_fitness,
                history_len=len(art.history), evaluations=art.evaluations,
                offspring_evaluated=art.offspring_evaluated)


def engine_of(session):
    pop = getattr(session.evaluator, "_pop", None)
    return pop.stats() if pop is not None else None


def job_record(name: str, session, art) -> dict:
    """One job's line; its engine's own launch count must equal its
    batches (an engine counts its thread's launches only, so another
    worker's do not leak into it)."""
    eng = engine_of(session)
    rec = {"job": name, "wall_s": art.wall_s,
           "evals_per_sec": art.offspring_evaluated / art.wall_s,
           "label_launches": eng["label_launches"] if eng else 0,
           "batches": eng["batches"] if eng else 0,
           "engine": art.backend_stats.get("pop_backend")}
    if rec["label_launches"] != label_launches_for(rec["batches"]):
        raise AssertionError(f"{name}: engine counted "
                             f"{rec['label_launches']} launches in "
                             f"{rec['batches']} batches")
    return rec


def daemon_in_process() -> dict:
    """Part 1: ``ScheduleDaemon`` on the card (``device=None``), two worker
    threads, driven over HTTP.  Its sessions are recorded by a subclass put
    in place of the daemon's ``SearchSession`` (this script's spy; the
    daemon's code is unchanged), so every searched job's engine batches and
    an island job's spawned engines can be read after the run."""
    import repro_torch.serve.daemon as daemon_mod
    from repro_torch.serve import ScheduleDaemon

    sessions = []

    class Recorded(SearchSession):
        def run(self, progress=None):
            self.t_run = [time.perf_counter(), None]
            sessions.append(self)
            try:
                return super().run(progress=progress)
            finally:
                self.t_run[1] = time.perf_counter()

    daemon_mod.SearchSession = Recorded
    store = DAEMON_DIR / "in_process"
    shutil.rmtree(store, ignore_errors=True)
    cold = SearchSession(SearchSpec(**WARM_SPEC), device=DEV).run()
    t0 = time.perf_counter()
    svc = ScheduleDaemon(str(store), workers=2,
                         device=None if DEV == "cuda" else DEV)
    svc.start()
    start_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{svc.port}"
    jobs, out = {}, {"startup_s": start_s, "jobs": []}
    try:
        if svc.device.type != DEV:
            raise AssertionError(f"daemon device {svc.device}")
        reset_counts()
        # the two GA_RUNS at once, and a duplicate while they run
        for name in ("paper_ga", "random"):
            jobs[name] = http("POST", f"{base}/jobs", {
                "spec": SearchSpec(**GA_RUNS[name]["spec"]).to_dict()})
        dup = http("POST", f"{base}/jobs", {
            "spec": SearchSpec(**GA_RUNS["paper_ga"]["spec"]).to_dict()})
        if not dup["deduped"] or dup["attached_to"] != jobs["paper_ga"]["id"]:
            raise AssertionError(f"duplicate not attached: {dup}")
        done = {name: wait_job(base, j["id"]) for name, j in jobs.items()}
        dup = wait_job(base, dup["id"])
        if dup["outcome"] != "cache_hit" or dup["key"] != \
                done["paper_ga"]["key"]:
            raise AssertionError(f"duplicate: {dup}")
        by_spec = {json.dumps(s.spec.to_dict(), sort_keys=True): s
                   for s in sessions}
        for name in ("paper_ga", "random"):
            art = svc.store.load_key(done[name]["key"])
            if golden_of(art) != GA_RUNS[name]["golden"] or \
                    art.backend_stats["pop_backend"] != engine_name():
                raise AssertionError(f"daemon {name}: {golden_of(art)}")
            s = by_spec[json.dumps(SearchSpec(**GA_RUNS[name]["spec"])
                                   .to_dict(), sort_keys=True)]
            out["jobs"].append(job_record(name, s, art))
        (a0, a1), (b0, b1) = (s.t_run for s in sessions[:2])
        overlap = min(a1, b1) - max(a0, b0)
        if len(sessions) != 2 or overlap <= 0:
            raise AssertionError(f"the two searches did not overlap: "
                                 f"{len(sessions)} sessions, {overlap} s")
        out["concurrent_overlap_s"] = overlap
        # a repeat: served from the store, no search, no launch
        before = ga_labels.launches
        hit = http("POST", f"{base}/jobs", {
            "spec": SearchSpec(**GA_RUNS["paper_ga"]["spec"]).to_dict()})
        if hit["state"] != "done" or hit["outcome"] != "cache_hit" or \
                len(sessions) != 2 or ga_labels.launches != before:
            raise AssertionError(f"repeat: {hit}, {len(sessions)} sessions")
        # a warm-started job: its first generation holds the donor's winner
        warm = wait_job(base, http("POST", f"{base}/jobs", {
            "spec": SearchSpec(**WARM_SPEC).to_dict(),
            "warm_start": True})["id"])
        wart = svc.store.load_key(warm["key"])
        donor = GA_RUNS["paper_ga"]["golden"]["best_fitness"]
        if warm["outcome"] != "searched" or \
                wart.history[0] < cold.history[0] - 1e-9 or \
                wart.history[0] < donor - 1e-9:
            raise AssertionError(f"warm start: first generation "
                                 f"{wart.history[0]}, cold "
                                 f"{cold.history[0]}, donor {donor}")
        out["warm_first_gen"] = wart.history[0]
        out["cold_first_gen"] = cold.history[0]
        out["jobs"].append(job_record("warm_start", sessions[-1], wart))
        # a 2-island job: islands spawned from a worker thread
        ispec = SearchSpec(**ISLAND_SPEC, backend_config=island_config(2))
        idone = wait_job(base, http("POST", f"{base}/jobs", {
            "spec": ispec.to_dict()})["id"])
        iart = svc.store.load_key(idone["key"])
        isess = sessions[-1]
        engines = [info["engine"] for info in isess.backend.island_info]
        want_method = "spawn" if DEV == "cuda" else "fork"
        if island_golden_of(iart) != ISLAND_RUNS[2] or \
                isess.backend.start_method != want_method or \
                len(engines) != 2 \
                or any(e["backend"] != engine_name() or not e["batches"]
                       or e["label_launches"] !=
                       label_launches_for(e["batches"]) for e in engines):
            raise AssertionError(f"island job: {island_golden_of(iart)}, "
                                 f"{isess.backend.start_method}, {engines}")
        rec = job_record("island_x2", isess, iart)
        rec["island_label_launches"] = [e["label_launches"] for e in engines]
        out["jobs"].append(rec)
        # a long job, cancelled while it runs
        long = http("POST", f"{base}/jobs", {
            "spec": SearchSpec(**LONG_SPEC).to_dict()})
        wait_running(base, long["id"])
        time.sleep(0.5)
        http("DELETE", f"{base}/jobs/{long['id']}")
        deadline = time.monotonic() + 60
        while http("GET", f"{base}/jobs/{long['id']}")["state"] \
                != "cancelled":
            if time.monotonic() > deadline:
                raise AssertionError("the long job was not cancelled")
            time.sleep(0.05)
        eng = engine_of(sessions[-1])
        if eng["label_launches"] != label_launches_for(eng["batches"]):
            raise AssertionError(f"cancelled job's engine: {eng}")
        out["jobs"].append({"job": "cancelled", "batches": eng["batches"],
                            "label_launches": eng["label_launches"],
                            "engine": eng["backend"]})
        launches = read_counts()
        out["metrics"] = http("GET", f"{base}/metrics")["jobs"]
    finally:
        svc.stop()
        daemon_mod.SearchSession = SearchSession
    batches = sum((engine_of(s) or {"batches": 0})["batches"]
                  for s in sessions)
    expect = dict.fromkeys(KERNELS, 0)
    expect["ga_labels"] = label_launches_for(batches)
    if launches != expect:
        raise AssertionError(f"daemon launches {launches} != the searched "
                             f"jobs' batches {batches}")
    out["label_launches_in_process"] = batches
    out["label_launches_in_islands"] = sum(rec["island_label_launches"])
    out["wall_s"] = time.perf_counter() - t0
    log(f"[daemon] {json.dumps(out)}")
    return {"launches": launches,
            "child_launches": {"ga_labels":
                               out["label_launches_in_islands"]}}


def start_daemon(store: str, *extra):
    """``python -m repro_torch daemon`` (on the card) on a free port;
    returns (process, base URL, seconds to listening, its output so far)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "daemon", "--store", store,
         "--port", "0", *extra, *DEVICE_ARGS], cwd=DAEMON_DIR,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip())
        if "listening on " in line:
            base = line.split("listening on ", 1)[1].split()[0]
            return proc, base, time.perf_counter() - t0, lines
    raise AssertionError(f"daemon did not start (rc {proc.wait()}):\n"
                         + "\n".join(lines))


def stop_daemon(proc) -> float:
    t0 = time.perf_counter()
    proc.terminate()
    try:
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return time.perf_counter() - t0


def run_main(*argv) -> tuple:
    """``python -m repro_torch <argv>`` in this process: (exit code,
    stdout)."""
    import contextlib
    import io

    from repro_torch.__main__ import main as cli_main
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(DAEMON_DIR)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(list(argv))
    finally:
        os.chdir(cwd)
    return rc, buf.getvalue()


def daemon_restart() -> dict:
    """Part 2: the daemon as a user runs it, in subprocesses: an island
    job submitted with ``jobs submit``, the daemon stopped (SIGTERM) while
    the job runs, restarted on the same store, the job re-run by the
    journal's replay to ISLAND_RUNS; then ``store gc`` (``--dry-run``
    first) with a queued job pinning a key."""
    from repro_torch.serve.queue import JobQueue
    out = {}
    proc, base, out["startup_s"], _ = start_daemon("R", "--workers", "1")
    try:
        sub, out["submit_s"] = cli(
            "jobs", "--daemon", base, "submit", "--workload",
            RESTART_SPEC["workload"], "--accelerator",
            RESTART_SPEC["accelerator"], "--backend", RESTART_SPEC["backend"],
            "--backend-config", json.dumps(RESTART_SPEC["backend_config"]),
            "--seed", str(RESTART_SPEC["seed"]), "--json", cwd=DAEMON_DIR)
        jid = json.loads(sub)["id"]
        wait_running(base, jid)
        time.sleep(1.0)                  # its islands are starting
    finally:
        out["stop_s"] = stop_daemon(proc)
    t0 = time.perf_counter()
    proc, base, out["restart_startup_s"], lines = start_daemon(
        "R", "--workers", "1")
    try:
        if not any("1 requeued" in ln for ln in lines):
            raise AssertionError("restart did not requeue the job:\n"
                                 + "\n".join(lines))
        job = wait_job(base, jid)
        out["replay_to_done_s"] = time.perf_counter() - t0
        small = wait_job(base, http("POST", f"{base}/jobs", {
            "spec": SearchSpec(workload="vgg16", backend_config={
                "preset": "fast", "generations": 8}).to_dict()})["id"])
    finally:
        stop_daemon(proc)
    from repro_torch.search import ScheduleArtifact
    store = DAEMON_DIR / "R" / "objects"
    art = ScheduleArtifact.load(str(store / job["key"][:2] /
                                    f"{job['key']}.json"))
    if job["outcome"] != "searched" or \
            island_golden_of(art) != RESTART_GOLDEN or \
            art.backend_stats["pop_backend"] != engine_name():
        raise AssertionError(f"replayed job: {job}, {island_golden_of(art)}")
    # store gc: a queued job pins the island artifact; one object may stay
    q = JobQueue(str(DAEMON_DIR / "R"))
    q.submit(art.spec.to_dict(), key=job["key"])
    q.close()
    for dry in (True, False):
        rc, text = run_main("store", "gc", "--store", "R", "--max-objects",
                            "1", "--json", *(["--dry-run"] if dry else []))
        res = json.loads(text)
        if rc != 0 or res["evicted"] != [small["key"]] or \
                res["kept_live"] != [job["key"]] or res["dry_run"] != dry:
            raise AssertionError(f"store gc (dry run {dry}): {res}")
    left = sorted(p.stem for p in store.rglob("*.json"))
    if left != [job["key"]]:
        raise AssertionError(f"store after gc: {left}")
    out["gc"] = res
    log(f"[restart] {json.dumps(out)}")
    return out


def spacemap_and_file() -> dict:
    """Part 3, in this process: ``analyze --json`` against the golden map;
    the spacemap GA and the per-region exhaustive run on the card against
    their goldens; ``export`` of mobilenet_v3 and ``search --workload
    file:...`` on the card against the zoo run; ``verify`` of every
    artifact of the phase."""
    out = {}
    rc, text = run_main("analyze", ANALYZE_GOLDEN["workload"], "--accel",
                        ANALYZE_GOLDEN["accelerator"], "--json")
    doc = json.loads(text)
    digest = hashlib.sha256(text.rstrip("\n").encode()).hexdigest()
    if rc != 0 or digest != ANALYZE_GOLDEN["sha256"] or \
            len(doc["summary"]["forced_off"]) != ANALYZE_GOLDEN["frozen"]:
        raise AssertionError(f"analyze: rc {rc}, {digest}")
    reset_counts()
    batches = 0
    paths = []
    for name, run in SPACEMAP_RUNS.items():
        session = SearchSession(SearchSpec(**run["spec"]), device=DEV)
        art = session.run()
        eng = engine_of(session)
        batches += eng["batches"] if eng else 0
        want_engine = "off" if run["spec"]["backend"] == "exhaustive" \
            else engine_name()
        if golden_of(art) != run["golden"] or art.spacemap is None or \
                art.backend_stats["pop_backend"] != want_engine:
            raise AssertionError(f"{name}: {golden_of(art)}, "
                                 f"{art.backend_stats['pop_backend']}")
        out[name] = job_record(name, session, art)
        paths.append(str(DAEMON_DIR / f"{name}.json"))
        art.save(paths[-1])
    rc, _ = run_main("export", "--workload", "mobilenet_v3", "--out",
                     "mobilenet_v3.json")
    spec = GA_RUNS[FILE_RUN["run"]]["spec"]
    rc2, text = run_main(
        "search", "--workload", "file:mobilenet_v3.json", "--accelerator",
        spec["accelerator"], "--backend", spec["backend"],
        "--backend-config", json.dumps(spec["backend_config"]), "--seed",
        str(spec["seed"]), "--out", "file_run.json", *DEVICE_ARGS)
    from repro_torch.search import ScheduleArtifact
    paths.append(str(DAEMON_DIR / "file_run.json"))
    art = ScheduleArtifact.load(paths[-1])
    batches += art.backend_stats["pop_batches"]
    if rc or rc2 or golden_of(art) != GA_RUNS[FILE_RUN["run"]]["golden"] \
            or art.graph_fingerprint != FILE_RUN["fingerprint"] \
            or art.graph_ir is None \
            or art.backend_stats["pop_backend"] != engine_name():
        raise AssertionError(f"file: run: {golden_of(art)}, "
                             f"{art.graph_fingerprint}")
    out["file_run"] = {"wall_s": art.wall_s, "evals_per_sec":
                       art.offspring_evaluated / art.wall_s,
                       "batches": art.backend_stats["pop_batches"],
                       "engine": art.backend_stats["pop_backend"]}
    launches = read_counts()
    expect = dict.fromkeys(KERNELS, 0)
    expect["ga_labels"] = label_launches_for(batches)
    if launches != expect:
        raise AssertionError(f"spacemap/file: launches {launches} != "
                             f"batches {batches}")
    n = len(paths)
    rc, text = run_main("verify", *paths)
    rc2, text2 = run_main("verify", "--store", "in_process")
    rc3, text3 = run_main("verify", "--store", "R")
    if rc or f"{n} artifact(s): {n} verified, 0 failed" not in text or \
            rc2 or "4 artifact(s): 4 verified, 0 failed" not in text2 or \
            rc3 or "1 artifact(s): 1 verified, 0 failed" not in text3:
        raise AssertionError(f"verify:\n{text}\n{text2}\n{text3}")
    log(f"[spacemap] {json.dumps(out)}")
    return {"launches": launches}


# the ``from_torch`` import: SmokeCNN's graph (the fingerprint ``from_jax``
# gives for the same network written in JAX) and the reference's result
# for its search (``repro.search.SearchSession.from_objects`` on that graph
# with FROM_TORCH_RUN's arguments); pinned by tests/test_torch_trace.py
FROM_TORCH_RUN = dict(
    input_shape=(1, 3, 64, 64), accelerator="simba",
    search=dict(backend="ga", backend_config={"preset": "paper"}, seed=0),
    fingerprint="ir1:a470d342f2081254bb13080ed59f04e7dbfd54c3cc9dadcd945b87"
                "35037ea7d0",
    golden=dict(genome_mask=0x33fcb, best_fitness=2.051913528129443,
                evaluations=8951))


class SmokeCNN(nn.Module):
    """Phase 8's ``from_torch`` import: a stem conv with batch norm, a
    depthwise-separable block with squeeze-excite and a residual add, max
    pooling, two 1x1 branches concatenated, a conv, global pooling and a
    classifier (tests/test_torch_trace.py writes the same network in JAX
    for ``from_jax``)."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 16, 3, stride=2, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(16)
        self.dw = nn.Conv2d(16, 16, 3, padding=1, groups=16)
        self.pw = nn.Conv2d(16, 16, 1)
        self.se1 = nn.Linear(16, 4)
        self.se2 = nn.Linear(4, 16)
        self.pool = nn.MaxPool2d(2)
        self.a = nn.Conv2d(16, 8, 1)
        self.b = nn.Conv2d(16, 8, 1)
        self.head = nn.Conv2d(16, 32, 3, padding=1)
        self.gap = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(32, 10)

    def forward(self, x):
        y = F.relu(self.bn(self.stem(x)))
        z = self.pw(F.relu(self.dw(y)))
        s = torch.sigmoid(self.se2(F.relu(self.se1(z.mean((2, 3))))))
        y = self.pool(y + z * s.view(1, -1, 1, 1))
        y = torch.cat([self.a(y), self.b(y)], 1)
        y = F.relu(self.head(y))
        return self.fc(torch.flatten(self.gap(y), 1))


def from_torch_run() -> dict:
    """Phase 8's last part: ``from_torch`` of SmokeCNN (on the card, in eval
    mode) against FROM_TORCH_RUN's fingerprint, then its search on the card
    against the golden result, one label launch per engine batch."""
    from repro_torch.costmodel import SIMBA
    from repro_torch.ir import from_torch
    run = FROM_TORCH_RUN
    model = SmokeCNN().to(DEV).eval()
    t0 = time.perf_counter()
    gir = from_torch(model, (torch.zeros(run["input_shape"], device=DEV),),
                     name="smoke_cnn")
    trace_s = time.perf_counter() - t0
    graph = gir.build()
    session = SearchSession.from_objects(graph, SIMBA, device=DEV,
                                         **run["search"])
    reset_counts()
    art = session.run()
    launches = read_counts()
    eng = engine_of(session)
    out = {"fingerprint": gir.fingerprint(), "layers": len(gir.nodes),
           "kinds": [n["kind"] for n in gir.nodes], "trace_s": trace_s,
           **job_record("from_torch", session, art)}
    log(f"[from_torch] {json.dumps(out)}")
    expect = dict.fromkeys(KERNELS, 0)
    expect["ga_labels"] = label_launches_for(eng["batches"])
    if gir.fingerprint() != run["fingerprint"] or \
            golden_of(art) != run["golden"] or launches != expect or \
            art.backend_stats["pop_backend"] != engine_name():
        raise AssertionError(f"from_torch: {gir.fingerprint()}, "
                             f"{golden_of(art)}, launches {launches}")
    return {"launches": launches}


def phase_daemon() -> dict:
    """Phase 8: the in-process daemon on the card (two concurrent GA_RUNS
    jobs, a duplicate, a store hit, a warm start, a 2-island job, a
    cancelled job), the daemon's restart replay and ``store gc`` in
    subprocesses, then the spacemap and ``file:`` runs and the
    ``from_torch`` import.  Returns the in-process runs, counted with phases
    4-7's."""
    t0 = time.perf_counter()
    shutil.rmtree(DAEMON_DIR, ignore_errors=True)
    DAEMON_DIR.mkdir(parents=True)
    runs = {"daemon": daemon_in_process()}
    daemon_restart()
    runs["spacemap_file"] = spacemap_and_file()
    runs["from_torch"] = from_torch_run()
    log(f"[daemon] phase 8 took {time.perf_counter() - t0:.1f} s")
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


# ---- phase 9: training ------------------------------------------------------

# phase 9's training runs, the slice's main paths, at the published widths,
# bf16, AdamW with each config's moment dtype (fp32; llama4 bf16).  Depth
# (and rows) cut only as the card's 80 GB forces (peaks measured on an
# H100 80GB HBM3 at 700 W; ``--train-probe`` places the new depths):
# - qwen2-7b: 8 of 28 layers (AdamW's state at full depth, 12 bytes a
#   parameter, is 91 GB), 8 x 1024 tokens, under each remat policy;
# - recurrentgemma-2b: 24 of its 26 layers, the most whole (rglru, rglru,
#   attn_local) patterns that fit (2.89 B parameters, 35 GB of state at
#   full depth, and 8.4 GB of fp32 logits at 2 x 4096, with their
#   log-softmax and its gradient; 75.2 GB at 24 layers), 2 x 4096 tokens so
#   that the 2048-key window skips tiles; all 26 under ``full`` (54.8 GB);
# - falcon-mamba-7b: 5 of its 64 layers at 8 x 1024 tokens (autograd keeps
#   da and dbx, (B, S, Di, N) fp32, 4.3 GB each a layer: 70.6 GB at 5
#   layers, and a sixth does not fit);
# - chatglm3-6b: 19 of 28 layers at 8 x 1024 (3.35 GB a layer over 11.9
#   before the forward kept O's rounding residual; 76.9 GB; its state
#   alone at 28 layers is 75 GB, so no policy reaches them);
# - stablelm-1.6b (24), starcoder2-3b (30) at 8 x 1024 and phi-3-vision-4.2b
#   (32) at 2 x (1024 image + 1024 text): their published depth, without
#   remat (44.2, 62.9 and 55.4 GB);
# - whisper-small: 12 + 12 layers, 8 x 448 decoder tokens over 1500 frames;
# - dbrx-132b: 1 of 40 layers (16 experts of 6144 x 10752: 54 GB of state
#   for one layer and the embeddings), 8 x 1024;
# - llama4-maverick-400b-a17b: its first layer (chunked attention, dense
#   FFN), 2 x 8200 so the chunk mask cuts in; its first MoE layer (128 x 3
#   x 5120 x 8192 = 16.1 B parameters, ~129 GB of state) cannot fit.
# (arch, layers, batch, seq, lr, steps, remat); each step takes the
# pipeline's next batch.  falcon-mamba-7b runs at AdamW's default lr, 3e-4,
# for 12 steps: at 1e-3 its loss rose over 12 steps (11.88 -> 13.10), and
# over 4 steps, at each lr tried from 1e-4 to 1e-2, the batches' spread
# (~0.03) outweighed what it learned or the loss rose.  starcoder2-3b,
# phi-3-vision-4.2b and whisper-small run at 3e-4: over 4 steps at 1e-3
# the first two rose (11.30 -> 11.42, 10.88 -> 10.90) and whisper-small's
# fell by 0.014 only (``repro_torch.launch.train``, the same weights and
# batches).  chatglm3-6b runs at 1e-4 for 12 steps: over 4 steps its loss
# rose at 1e-3, 3e-4 and 1e-4 (the fourth batch reads ~0.05-0.08 above the
# first at any of them); over 12 at 3e-4 it fell to 11.32-11.40 by steps
# 7-11 and the twelfth batch, the hardest, read 11.67 (11.56 at the first),
# at 1e-3 it rose to 12.53.
TRAIN_RUNS = (("qwen2-7b", 8, 8, 1024, 1e-3, 4, "none"),
              ("qwen2-7b", 8, 8, 1024, 1e-3, 4, "selective"),
              ("qwen2-7b", 8, 8, 1024, 1e-3, 4, "full"),
              ("recurrentgemma-2b", 24, 2, 4096, 1e-3, 4, "none"),
              ("recurrentgemma-2b", 26, 2, 4096, 1e-3, 4, "full"),
              ("falcon-mamba-7b", 5, 8, 1024, 3e-4, 12, "none"),
              ("chatglm3-6b", 19, 8, 1024, 1e-4, 12, "none"),
              ("stablelm-1.6b", 24, 8, 1024, 1e-3, 4, "none"),
              ("starcoder2-3b", 30, 8, 1024, 3e-4, 4, "none"),
              ("phi-3-vision-4.2b", 32, 2, 1024, 3e-4, 4, "none"),
              ("whisper-small", 12, 8, 448, 3e-4, 4, "none"),
              ("dbrx-132b", 1, 8, 1024, 1e-3, 4, "none"),
              ("llama4-maverick-400b-a17b", 1, 2, 8200, 1e-3, 4, "none"))
# the runs of this config under each policy are held to one another
# (``remat_compare``)
REMAT_ARCH = "qwen2-7b"
# the gradient checks (arch, layers, batch, seq, remat): the runs' widths at
# 1 or 2 layers (recurrentgemma-2b: one whole pattern, 3 layers; whisper:
# 2 encoder and 2 decoder layers; the MoE models 1, as they train) and the
# runs' sequence lengths (llama4: one row of 8200, past its first chunk);
# under remat, a config of each layer kind that no run recomputes (the
# Mamba block, the encoder and cross attention, the MoE dispatch, the
# chunk mask)
GRAD_CHECKS = (("qwen2-7b", 2, 2, 1024, "none"),
               ("qwen2-7b", 2, 2, 1024, "full"),
               ("recurrentgemma-2b", 3, 2, 4096, "none"),
               ("falcon-mamba-7b", 2, 2, 1024, "none"),
               ("falcon-mamba-7b", 2, 2, 1024, "full"),
               ("chatglm3-6b", 2, 2, 1024, "none"),
               ("stablelm-1.6b", 2, 2, 1024, "none"),
               ("starcoder2-3b", 2, 2, 1024, "none"),
               ("phi-3-vision-4.2b", 2, 2, 1024, "none"),
               ("whisper-small", 2, 2, 448, "none"),
               ("whisper-small", 2, 2, 448, "full"),
               ("dbrx-132b", 1, 2, 1024, "none"),
               ("dbrx-132b", 1, 2, 1024, "selective"),
               ("llama4-maverick-400b-a17b", 1, 1, 8200, "none"),
               ("llama4-maverick-400b-a17b", 1, 1, 8200, "selective"))
# REMAT_ARCH's depths and tokens for the bytes a forward saves
# (``remat_costs``)
REMAT_DEPTHS = (2, 8)
REMAT_TOKENS = (8, 1024)
# scratch checkpoints of the reference's restart test
TRAIN_DIR = ROOT / "build" / "train"
# the reduced recurrent configs on the card in fp32 against the CPU's plain
# path: relative RMS error of each gradient leaf (tests/test_torch_train.py's
# GRAD_RTOL: fp32 sums in another order)
REDUCED_GRAD_RTOL = 1e-4
# ``--train-probe``: (arch, batch, seq, depths, remat), and the peak that
# the depths it reports keep under, of the card's 85 GB
TRAIN_PROBES = (
    ("chatglm3-6b", 8, 1024, (2, 6), "none"),
    ("stablelm-1.6b", 8, 1024, (4, 12), "none"),
    ("starcoder2-3b", 8, 1024, (4, 12), "none"),
    ("starcoder2-3b", 8, 1024, (4, 12), "full"),
    ("phi-3-vision-4.2b", 2, 1024, (4, 12), "none"),
    ("phi-3-vision-4.2b", 2, 1024, (4, 12), "full"),
    ("whisper-small", 8, 448, (4, 12), "none"),
    ("dbrx-132b", 8, 1024, (1,), "none"),
    ("dbrx-132b", 4, 1024, (1,), "none"),
    ("llama4-maverick-400b-a17b", 2, 8200, (1,), "none"),
    ("llama4-maverick-400b-a17b", 1, 8200, (1,), "none"),
    ("qwen2-7b", 8, 1024, (2, 8), "none"),
    ("qwen2-7b", 8, 1024, (2, 8), "selective"),
    ("qwen2-7b", 8, 1024, (2, 8), "full"),
    ("recurrentgemma-2b", 2, 4096, (9, 26), "full"),
)
PROBE_FIT_GB = 76.0


def flash_bwd_cases() -> list:
    """(name, (B, Sq, Skv, Hq, Hkv, D), causal, window, chunk): the
    training path's masks (causal, window, chunk, none with Sq != Skv) at
    the attention configs' head dims, ragged lengths, D 16 and 32 (the
    reduced configs), and G (query heads a kv head) 1, 4, 7, 10 and 12.
    The first BWD_TIMED are timed: qwen2-7b's training shape (D 128),
    stablelm-1.6b's (D 64, MHA), phi-3-vision's (D 96) and
    recurrentgemma-2b's local attention (MQA 10:1, D 256, window 2048 over
    4096 positions)."""
    return [
        ("qwen2-7b 8x1024 G7", (8, 1024, 1024, 28, 4, 128), True, 0, 0),
        ("stablelm-1.6b 8x1024 MHA", (8, 1024, 1024, 32, 32, 64), True, 0,
         0),
        ("phi-3-vision 2x2048 D96", (2, 2048, 2048, 32, 32, 96), True, 0, 0),
        ("recurrentgemma-2b 2x4096 window 2048 D256 G10",
         (2, 4096, 4096, 10, 1, 256), True, 2048, 0),
        ("whisper encoder 1500x1500", (8, 1500, 1500, 12, 12, 64), False, 0,
         0),
        ("whisper cross 448x1500", (8, 448, 1500, 12, 12, 64), False, 0, 0),
        ("chunk 64", (2, 300, 300, 8, 2, 64), True, 0, 64),
        ("ragged causal G4", (2, 77, 77, 4, 1, 128), True, 0, 0),
        ("ragged unmasked G12", (2, 100, 150, 12, 1, 32), False, 0, 0),
        ("D16 causal", (2, 70, 70, 4, 2, 16), True, 0, 0),
        ("D32 G12 chunk", (2, 130, 130, 24, 2, 32), True, 0, 48),
        ("ragged chunk 40 D96 G7", (1, 203, 203, 7, 1, 96), True, 0, 40),
        ("reduced recurrentgemma-2b window 8 D16", (2, 70, 70, 4, 1, 16),
         True, 8, 0),
        ("ragged window 100 D64", (2, 300, 300, 8, 2, 64), True, 100, 0),
        ("ragged window 50 D128 G7", (1, 203, 203, 7, 1, 128), True, 50, 0),
        ("window 33 unmasked D96 Sq!=Skv", (1, 90, 150, 4, 2, 96), False, 33,
         0),
        ("ragged D256 causal G10", (1, 100, 100, 10, 1, 256), True, 0, 0),
        ("ragged window 40 D256 G10", (1, 137, 137, 10, 1, 256), True, 40,
         0),
    ]


BWD_TIMED = 4


def window_mask(Sq: int, Skv: int, causal: bool, window: int,
                chunk: int) -> torch.Tensor:
    """(Sq, Skv) bool on the card: which keys each query sees (queries
    from position 0, every key written)."""
    qp = torch.arange(Sq, device=DEV)[:, None]
    kp = torch.arange(Skv, device=DEV)[None, :]
    seen = torch.ones(Sq, Skv, dtype=torch.bool, device=DEV)
    if causal:
        seen &= kp <= qp
    if window:
        seen &= kp > qp - window
    if chunk:
        seen &= kp // chunk == qp // chunk
    return seen


def flash_bwd_work(B, Sq, Skv, Hq, Hkv, D, dt, causal, chunk,
                   window=0, o_lo: bool = False) -> dict:
    """q, k, v, o, dO, lse (and o_lo, where the forward wrote one) read
    once, dq, dk, dv written once; 2.5x the forward's 4*D flops a visible
    (query, key) pair (the usual count of the five products, S recomputed
    once)."""
    fwd = flash_work(B, Sq, Skv, Hq, Hkv, D, dt, causal=causal,
                     window=window, chunk=chunk)
    nbytes = ((4 + o_lo) * B * Sq * Hq * D + 4 * B * Skv * Hkv * D) \
        * esize(dt) + 4 * B * Hq * Sq
    return bound(nbytes, int(2.5 * fwd["flops"]), dt)


def sdpa_bwd_times(timer: Timer, q, k, v, do, causal: bool, window: int,
                   chunk: int) -> dict:
    """SDPA's backward on the same inputs, which the port never calls: its
    forward and its forward and backward, timed in turns, and their
    difference (a window or chunk as a boolean mask)."""
    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    mask = (window_mask(Sq, Skv, causal, window, chunk)
            if window or chunk else None)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    t = in_turns(timer, {"fwd": sdpa_fwd, "both": sdpa_fwd_bwd})
    return {"library_ms": t["both"] - t["fwd"], "library_fwd_ms": t["fwd"],
            "library_fwd_bwd_ms": t["both"]}


def bwd_variants(shape, dt) -> list:
    """(impl, forced) of every backward kernel that takes a case: the
    plan's first (not forced), then the other kernel where it takes the
    case."""
    B, Sq, Skv, Hq, Hkv, D = shape
    planned = plan_bwd(B, Sq, Skv, Hq, Hkv, D, dt)
    out = [(planned, False)]
    for impl in flash_ops.BWD_IMPLS:
        try:
            plan_bwd(B, Sq, Skv, Hq, Hkv, D, dt, impl)
        except ValueError:
            continue
        if impl != planned:
            out.append((impl, True))
    return out


def bwd_rows(Sq: int, Skv: int, causal: bool, chunk: int,
             window: int = 0) -> dict:
    """The rows of dq (queries) and dk (keys) that the row check holds: a
    query that sees one key has dq = 0 exactly (the softmax of one score
    has no gradient), and so has a key that only such queries see; there
    both the kernel and the plain version return rounding noise, which TOL
    holds and a row's own scale cannot.  Every row of dv."""
    seen = window_mask(Sq, Skv, causal, window, chunk)
    one = seen.sum(1) == 1
    return {"dq": ~one, "dk": (seen & ~one[:, None]).any(0),
            "dv": torch.ones(Skv, dtype=torch.bool, device=DEV)}


def bwd_check(name: str, grads, refs, dt, causal: bool, chunk: int,
              window: int = 0) -> dict:
    """dq, dk and dv against the plain version's: the max abs error of
    each; raises beyond TOL or, in bf16, row by row (one head's D gradients
    of a query or a key, ``bwd_rows``) beyond FLASH_ROW_TOL.  TOL's
    absolute part is 2e-2 in bf16, about the gradient of a late key at
    1024 positions, so a kernel that dropped the diagonal or the last key
    tile could pass it; the row check sees that (``bwd_last_key_probe``).
    In fp32 TOL's 2e-5 already does, and a dq row of a few keys whose terms
    cancel can sit beyond 2e-5 of its own scale by fp32's rounding alone
    (tests/test_torch_flash_bwd_tc.py shows one), so fp32 is held to TOL."""
    errs, bad = {}, []
    rows = bwd_rows(grads[0].shape[1], grads[1].shape[1], causal, chunk,
                    window)
    for n, g, r in zip(("dq", "dk", "dv"), grads, refs):
        try:
            errs[n] = close(g, r, TOL[dt])
        except AssertionError as e:
            bad.append(f"{n}: {e}")
            continue
        if dt != torch.bfloat16:
            continue
        row_err = row_scaled_err(g[:, rows[n]], r[:, rows[n]])
        if not row_err <= FLASH_ROW_TOL[dt]:
            raise AssertionError(f"flash_attention_bwd {name} {dt} {n}: "
                                 f"error {row_err:.3e} of the rows' scale "
                                 f"> {FLASH_ROW_TOL[dt]:g}")
        errs[n + "_row"] = row_err
    if bad:
        raise AssertionError(f"flash_attention_bwd {name} {dt}: "
                             f"{'; '.join(bad)}")
    return errs


def o_lo_check(name: str, o, o_lo, fwd_impl: str) -> dict | None:
    """The forward's rounding residual of O: written by ``tc_prefill`` with
    the log-sum-exp and by no other kernel; each element within half an
    ulp of O's bf16 (|o_lo| <= 2^-8 |o|) and not all zero."""
    if (o_lo is not None) != (fwd_impl == "tc_prefill"):
        raise AssertionError(f"flash {name}: o_lo from {fwd_impl}: "
                             f"{o_lo is not None}")
    if o_lo is None:
        return None
    ratio = float((o_lo.float().abs() / o.float().abs().clamp_min(1e-30))
                  .max())
    nonzero = float((o_lo != 0).float().mean())
    if not (ratio <= 2.0 ** -8 * 1.001 and nonzero > 0.5):
        raise AssertionError(f"flash {name}: o_lo is no rounding residual "
                             f"of o: max |o_lo|/|o| {ratio:.3e}, nonzero "
                             f"{nonzero:.3f}")
    return {"max_rel": ratio, "nonzero_share": nonzero}


def bwd_last_key_probe(q, k, v, o, lse, do, refs, causal, chunk,
                       window=0, o_lo=None) -> dict:
    """The plain version without the last key (its dk and dv rows zero):
    what a kernel that dropped it would return.  It must fail FLASH_ROW_TOL
    on dk and dv, or the check could not see such a kernel; whether it
    also fails TOL is recorded."""
    dropped = attention_bwd_ref(q, k[:, :-1].contiguous(),
                                v[:, :-1].contiguous(), o, lse, do,
                                causal=causal, window=window, chunk=chunk,
                                o_lo=o_lo)
    rows = bwd_rows(q.shape[1], k.shape[1], causal, chunk, window)
    out = {}
    for n, g, r in zip(("dk", "dv"), dropped[1:], refs[1:]):
        g = torch.cat([g, torch.zeros_like(r[:, -1:])], 1)
        row_err = row_scaled_err(g[:, rows[n]], r[:, rows[n]])
        if not row_err > FLASH_ROW_TOL[q.dtype]:
            raise AssertionError(f"flash_attention_bwd: without the last "
                                 f"key {n} is within FLASH_ROW_TOL "
                                 f"({row_err:.3e})")
        try:
            close(g, r, TOL[q.dtype])
            passes_tol = True
        except AssertionError:
            passes_tol = False
        out[n] = {"row_err": row_err, "passes_tol": passes_tol}
    return out


def kernels_flash_bwd(timer: Timer, rn) -> list:
    """Each ``flash_bwd_cases`` case in bf16 and fp32: the forward kernel
    with its log-sum-exp (the plan's prefill kernel) against the plain
    version's output and ``logsumexp`` of its scaled, masked scores, then
    every backward variant that takes the case (``bwd_variants``: the
    plan's kernel, the other kernel forced), each one's dq, dk and dv
    against ``attention_bwd_ref`` on the same q, k, v, o, lse and dO, within
    TOL and FLASH_ROW_TOL (``bwd_check``).  The first BWD_TIMED cases are
    timed in bf16: every variant (and its launches apart,
    ``launch_times``), the plain version and SDPA's backward (forward and
    backward minus forward; a window as a boolean mask), which the port
    never calls; at each of them ``bwd_last_key_probe`` shows that the row
    check sees a kernel that drops the last key."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for i, (name, (B, Sq, Skv, Hq, Hkv, D), causal, window, chunk) in \
                enumerate(flash_bwd_cases()):
            q, k, v = rn(B, Sq, Hq, D, dt=dt), rn(B, Skv, Hkv, D, dt=dt), \
                rn(B, Skv, Hkv, D, dt=dt)
            do = rn(B, Sq, Hq, D, dt=dt)
            masks = dict(causal=causal, window=window, chunk=chunk)
            before = dict(flash_attention.impl_launches)
            o, lse, o_lo = flash_forward(q, k, v, q_offset=0, kv_len=None,
                                         k_pos=None, impl=None, splits=None,
                                         with_lse=True, **masks)
            fwd_impl = next(n for n, c in flash_attention.impl_launches.items()
                            if c > before[n])
            ref_o, ref_lse = attention_ref(q, k, v, return_lse=True, **masks)
            err_o, _ = flash_check(name, o, ref_o, dt)
            err_lse = close(lse, ref_lse, TOL[dt])
            residual = o_lo_check(name, o, o_lo, fwd_impl)
            refs = attention_bwd_ref(q, k, v, o, lse, do, o_lo=o_lo, **masks)
            timed = {}
            if dt == torch.bfloat16 and i < BWD_TIMED:
                probe = bwd_last_key_probe(q, k, v, o, lse, do, refs,
                                           causal, chunk, window, o_lo)
                timed = dict(
                    plain_ms=timer.ms(lambda: attention_bwd_ref(
                        q, k, v, o, lse, do, o_lo=o_lo, **masks), reps=5),
                    **sdpa_bwd_times(timer, q, k, v, do, **masks),
                    last_key_probe=probe,
                    **flash_bwd_work(B, Sq, Skv, Hq, Hkv, D, dt, causal,
                                     chunk, window, o_lo is not None))
            for impl, forced in bwd_variants((B, Sq, Skv, Hq, Hkv, D), dt):
                kw = dict(masks, impl=impl if forced else None, o_lo=o_lo)
                before = dict(flash_attention_bwd.impl_launches)
                grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
                moved = {n: c - before[n] for n, c in
                         flash_attention_bwd.impl_launches.items()}
                if moved != {n: int(n == impl) for n in moved}:
                    raise AssertionError(f"flash_attention_bwd {name}: "
                                         f"{moved}, not one {impl} launch")
                errs = bwd_check(name, grads, refs, dt, causal, chunk, window)
                case = {"case": name, "shape": [B, Sq, Skv, Hq, Hkv, D],
                        "causal": causal, "window": window, "chunk": chunk,
                        "dtype": str(dt)[6:], "impl": impl, "forced": forced,
                        "forward_impl": fwd_impl, "tol": TOL[dt],
                        "row_tol": FLASH_ROW_TOL[dt] if dt ==
                        torch.bfloat16 else None,
                        "max_abs_err": max(errs[n] for n in ("dq", "dk",
                                                             "dv")),
                        "err": errs, "forward_err": err_o,
                        "lse_err": err_lse, "o_lo": residual}
                if timed:
                    def call(marks=None):
                        return flash_attention_bwd(q, k, v, o, lse, do,
                                                   marks=marks, **kw)

                    case.update(ms=timer.ms(call), split_ms=launch_times(
                        timer, call, ("delta", "dkdv", "dq")), **timed)
                log(f"[train] flash_attention_bwd {case}")
                cases.append(case)
                del grads
            del q, k, v, do, o, lse, o_lo, refs, ref_o, ref_lse
            torch.cuda.empty_cache()
    return cases


def kernels_flash_bwd_fp32(timer: Timer, rn) -> list:
    """The ``simt`` backward in fp32 (the path of the grad checks' fp32
    gradients and the fp32 training tests) at phase 5's fp32 prefill
    shapes, the fp32 cases of FLASH_TIMED: dq, dk and dv against
    ``attention_bwd_ref`` within TOL, timed beside its bound (fp32's 67
    TFLOP/s) and SDPA's fp32 backward (forward and backward minus forward;
    a window or chunk as a boolean mask), which the port never calls."""
    dt = torch.float32
    shapes = {name: (shape, kw) for name, shape, kw in flash_cases()}
    cases = []
    for name in FLASH_TIMED[dt]:
        (B, Sq, Skv, Hq, Hkv, D), kw = shapes[name]
        masks = dict(causal=kw.get("causal", True),
                     window=kw.get("window", 0), chunk=kw.get("chunk", 0))
        q, k, v = rn(B, Sq, Hq, D, dt=dt), rn(B, Skv, Hkv, D, dt=dt), \
            rn(B, Skv, Hkv, D, dt=dt)
        do = rn(B, Sq, Hq, D, dt=dt)
        o, lse, _ = flash_forward(q, k, v, q_offset=0, kv_len=None,
                                  k_pos=None, impl=None, splits=None,
                                  with_lse=True, **masks)
        refs = attention_bwd_ref(q, k, v, o, lse, do, **masks)
        impl = plan_bwd(B, Sq, Skv, Hq, Hkv, D, dt)
        before = flash_attention_bwd.impl_launches[impl]
        grads = flash_attention_bwd(q, k, v, o, lse, do, **masks)
        if impl != "simt" or \
                flash_attention_bwd.impl_launches[impl] != before + 1:
            raise AssertionError(f"flash_attention_bwd fp32 {name}: {impl}")
        errs = bwd_check(name, grads, refs, dt, **masks)
        case = {"case": f"fp32 {name}", "shape": [B, Sq, Skv, Hq, Hkv, D],
                **masks, "dtype": "float32", "impl": impl, "forced": False,
                "tol": TOL[dt], "row_tol": None,
                "max_abs_err": max(errs.values()), "err": errs,
                "ms": timer.ms(lambda: flash_attention_bwd(
                    q, k, v, o, lse, do, **masks)),
                "plain_ms": timer.ms(lambda: attention_bwd_ref(
                    q, k, v, o, lse, do, **masks), reps=5),
                **sdpa_bwd_times(timer, q, k, v, do, **masks),
                **flash_bwd_work(B, Sq, Skv, Hq, Hkv, D, dt, masks["causal"],
                                 masks["chunk"], masks["window"])}
        log(f"[train] flash_attention_bwd {case}")
        cases.append(case)
        del q, k, v, do, o, lse, refs, grads
        torch.cuda.empty_cache()
    return cases


RGLRU_BWD_NAMES = ("dxa", "dxi", "dxc", "db_a", "db_i", "dlam", "dh0")


def rglru_bwd_shapes() -> tuple:
    """(B, S, W, h0, dh_last, timed): recurrentgemma-2b's training shape
    (2 x 4096 by 2560, from zero and without dh_last, as the model runs it);
    a chain that little else hides (1 x 4096 by 256: 64 chunks in series,
    four blocks each); then ragged ones: S not a multiple of the 64-step
    chunk in one, two and five chunks, W not a multiple of a thread's
    8-byte group (130, 129: element loads) or of a block's strip (20, 136),
    with h0 and dh_last."""
    rg = get_config("recurrentgemma-2b")
    return ((2, 4096, rg.rnn_width, False, False, True),
            (1, 4096, 256, False, False, True),
            (1, 45, 130, True, True, False),
            (3, 33, 20, True, False, False),
            (2, 1, 129, True, True, False),
            (1, 300, 64, False, True, False),
            (2, 100, 136, True, True, False))


def rglru_bwd_work(Bs, S, Wd, dt, h0: bool, dh_last: bool) -> dict:
    """The function's bytes: xa, xi, xc, dh read and dxa, dxi, dxc written
    once each, the (W,) vectors read and their gradients written, dh_last
    read and dh0 written where given, and the forward's states (fp32, one a
    chunk per (batch, channel)) read; ~50 fp32 operations an element (the
    forward's ~30, recomputed, and the reverse step and chain rule).  Beside
    the bound, ``scratch_bytes``: what the kernel's design moves besides,
    the fp64 partials of the (W,) sums (three a chunk per (batch, channel))
    written and read, the chain's slots set, written and read, and the
    counters set."""
    n = Bs * S * Wd
    rows = Bs * -(-S // RGLRU_BWD_STEPS) * Wd
    nbytes = 7 * n * esize(dt) + 6 * Wd * 4 + \
        (h0 + dh_last) * Bs * Wd * 4 + rows * 4
    return {**bound(nbytes, 50 * n, torch.float32),
            "scratch_bytes": 2 * 3 * rows * 8 + 3 * rows * 4 + (4 + Wd) * 4}


def rglru_states_check(args, h0, states, steps: int) -> float:
    """The forward's kept states: within the fp32 RG-LRU tolerance of
    ``rglru_states_ref``; the first is h0 (zero) exactly; and the state
    entering chunk k is bit for bit the h_last of the forward run on the
    first k chunks alone (the same tiles), at the second and the last
    chunk.  Returns the max abs error against the plain version."""
    err = close(states, rglru_states_ref(*args, h0, steps),
                TOL[torch.float32] * RGLRU_TOL_MULT)
    first = torch.zeros_like(states[:, 0]) if h0 is None else h0
    if not torch.equal(states[:, 0], first):
        raise AssertionError("rglru_gated states: the first is not h0")
    K = states.shape[1]
    for k in sorted({1, K - 1} & set(range(1, K))):
        part = [x[:, :k * steps].contiguous() for x in args[:3]]
        _, h_last = rglru_gated(*part, *args[3:], h0)
        if not torch.equal(states[:, k], h_last):
            raise AssertionError(f"rglru_gated states: chunk {k} is not the "
                                 f"h_last of the first {k * steps} steps")
    return err


def rglru_fwd_states_times(timer: Timer, g) -> dict:
    """The gated forward with and without kept states, in turns, at
    recurrentgemma-2b's serve prefill (8 x 4096) and training (2 x 4096)
    shapes in bf16: what keeping them costs the forward."""
    rg = get_config("recurrentgemma-2b")
    out = {}
    for Bs in (SERVES[1][1], 2):
        args, _ = rglru_gated_inputs(g, Bs, 4096, rg.rnn_width,
                                     torch.bfloat16)
        t = in_turns(timer, {
            "none": lambda: rglru_gated(*args),
            "states": lambda: rglru_gated(*args,
                                          states_every=RGLRU_BWD_STEPS)})
        out[f"{Bs}x4096"] = {"ms": t["none"], "states_ms": t["states"]}
        del args
    log(f"[train] rglru_gated forward with states {out}")
    return out


def kernels_rglru_bwd(timer: Timer, g) -> list:
    """The gated RG-LRU's backward against ``rglru_gated_bwd_ref`` on the
    card at ``rglru_bwd_shapes``, bf16 and fp32, within TOL x
    RGLRU_TOL_MULT (the RG-LRU's tolerance, as its forward: the kernel's
    sigmoids are the special-function unit's, and 1 / sqrt(1 - a^2) in the
    gradient magnifies a's last bit); whether each case is also within TOL
    is recorded.  Its states come from the forward kernel
    (``rglru_states_check``; the plain version also holds them to its
    own).  A second launch must give the same bits (no atomics, a fixed
    chain).  Timed in bf16 at the timed shapes beside its bound and the
    plain version, its two launches apart (``launch_times``), and the
    forward with and without states (``rglru_fwd_states_times``, on the
    first case); no PyTorch call computes a linear recurrence's
    backward."""
    cases = []
    fwd_times = rglru_fwd_states_times(timer, g)
    for dt in (torch.bfloat16, torch.float32):
        for Bs, S, Wd, with_h0, with_last, timed in rglru_bwd_shapes():
            args, h0 = rglru_gated_inputs(g, Bs, S, Wd, dt)
            h0 = h0 if with_h0 else None
            dh = torch.randn(Bs, S, Wd, generator=g, device=DEV).to(dt)
            dh_last = (torch.randn(Bs, Wd, generator=g, device=DEV)
                       if with_last else None)
            tol = TOL[dt] * RGLRU_TOL_MULT
            _, _, states = rglru_gated(*args, h0,
                                       states_every=RGLRU_BWD_STEPS)
            states_err = rglru_states_check(args, h0, states,
                                            RGLRU_BWD_STEPS)
            n0 = rglru_gated_bwd.launches
            got = rglru_gated_bwd(*args, h0, dh, dh_last, states)
            again = rglru_gated_bwd(*args, h0, dh, dh_last, states)
            if rglru_gated_bwd.launches != n0 + 2:
                raise AssertionError("rglru_gated_bwd: not one launch a call")
            want = rglru_gated_bwd_ref(*args, h0, dh, dh_last, states,
                                       RGLRU_BWD_STEPS)
            errs, within_tol, bad = {}, True, []
            for name, a, b, c in zip(RGLRU_BWD_NAMES, got, want, again):
                if b is None:
                    continue
                if not torch.equal(a, c):
                    raise AssertionError(f"rglru_gated_bwd {name}: two "
                                         f"launches differ")
                err = (a.float() - b.float()).abs()
                out = err > tol * (1 + b.float().abs())
                if not torch.isfinite(a).all() or out.any():
                    at = out.nonzero()[:4].tolist()
                    bad.append(f"{name}: {int(out.sum())} beyond {tol:g}, "
                               f"max {err.max().item():.3e}, first at {at}")
                    continue
                errs[name] = err.max().item()
                within_tol &= bool((err <= TOL[dt] * (1 + b.float().abs()))
                                   .all())
            if bad:
                raise AssertionError(f"rglru_gated_bwd {Bs}x{S}x{Wd} {dt}: "
                                     f"{'; '.join(bad)}")
            case = {"shape": [Bs, S, Wd], "dtype": str(dt)[6:],
                    "h0": with_h0, "dh_last": with_last, "tol": tol,
                    "steps": RGLRU_BWD_STEPS, "within_TOL": within_tol,
                    "max_abs_err": max(errs.values()), "err": errs,
                    "states_err": states_err}
            del got, again, want
            if timed and dt == torch.bfloat16:
                def call(marks=None):
                    return rglru_gated_bwd(*args, h0, dh, dh_last, states,
                                           marks=marks)

                case.update(
                    ms=timer.ms(call), split_ms=launch_times(
                        timer, call, ("memset", "bwd")),
                    plain_ms=timer.ms(lambda: rglru_gated_bwd_ref(
                        *args, h0, dh, dh_last), reps=3),
                    library_ms=None,
                    **rglru_bwd_work(Bs, S, Wd, dt, with_h0, with_last))
                if not cases:
                    case["forward_states_ms"] = fwd_times
            log(f"[train] rglru_gated_bwd {case}")
            cases.append(case)
            del args, h0, dh, dh_last, states
    torch.cuda.empty_cache()
    return cases


# The gated RG-LRU backward kernel's ablations (--rglru-ablate): edits of
# csrc/rglru_scan.cu, each taking a part of rg_bwd's work away, so that
# what is left is timed (the results are then wrong, and not checked).
RGLRU_ABLATIONS = {
    # no global reads of xa, xi, xc, dh: the staging slots zero-filled
    "no_copies": (("      if (Vec && u < n && whole) {",
                   "      if (false) {"),),
    # no wait for the e entering the chunk's end
    "no_chain": (("      wait_slots<V>(p.chain + row, nv, e);",
                  "      for (int v = 0; v < V; ++v) e[v] = 0.f;"),),
    # phase 3 without its gate_math (a from phase 1's registers)
    "one_gate_math": (
        ("        gate_math(xa[v], xi[v], prm[cv + v], prm[CB + cv + v], kk,"
         " r, i, av,\n                  y, s, rs);",
         "        r = xa[v]; i = xi[v]; av = a[u][v]; y = 1.f; s = xc[v];"
         " rs = 1.f;"),),
}
RGLRU_ABLATIONS["none_of_the_three"] = sum(RGLRU_ABLATIONS.values(), ())


def ptxas_report(log_text: str, kernel: str) -> dict:
    """Registers and spill stores by instance of ``kernel`` from ``nvcc
    -Xptxas -v`` output (instance: the mangled name's template part)."""
    out, name = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            name = (fn[fn.index(kernel) + len(kernel):].split("EEEvNS")[0]
                    if kernel in fn else None)
        elif name and "spill stores" in line:
            out.setdefault(name, {})["spill_stores"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(
                line.split("Used")[1].split()[0])
    return out


def rglru_ablate() -> None:
    """The backward kernel ``rg_bwd`` as built and with each of
    RGLRU_ABLATIONS applied to its source: every version built at once
    (nvcc -Xptxas -v: registers and spills by instance), then timed in
    turns through ``rglru_gated_bwd`` (its library swapped in) at the
    kernel's timed shapes in bf16, from the forward's states.  One
    ``[ablate]`` line a shape and a ``[ptxas]`` line a version."""
    src = (_build.CSRC / "rglru_scan.cu").read_text()
    texts = {"as_built": src}
    for name, edits in RGLRU_ABLATIONS.items():
        t = src
        for old, new in edits:
            if t.count(old) != 1:
                raise AssertionError(f"ablation {name}: the kernel source "
                                     f"changed ({old.strip()!r})")
            t = t.replace(old, new)
        texts[name] = t
    root = _build.BUILD_DIR.parent / "rglru_ablate"
    jobs = {}
    for name, text in texts.items():
        (root / name).mkdir(parents=True, exist_ok=True)
        cu, so = root / name / "rglru_scan.cu", root / name / "rglru_scan.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name}: nvcc failed\n{out}")
        log(f"[ptxas] {name} {json.dumps(ptxas_report(out, 'rg_bwd'))}")
        lib = ctypes.CDLL(str(so))
        lib.rglru_gated_bwd.argtypes = \
            rglru_scan_ops._fns().rglru_gated_bwd.argtypes
        lib.rglru_gated_bwd.restype = ctypes.c_int
        libs[name] = lib

    def through(lib, fn):
        def call():
            saved = rglru_scan_ops._fns
            rglru_scan_ops._fns = lambda: lib
            try:
                return fn()
            finally:
                rglru_scan_ops._fns = saved
        return call

    timer = Timer()
    g = torch.Generator(device=DEV).manual_seed(1)
    for Bs, S, Wd, with_h0, with_last, timed in rglru_bwd_shapes():
        if not timed:
            continue
        args, h0 = rglru_gated_inputs(g, Bs, S, Wd, torch.bfloat16)
        h0 = h0 if with_h0 else None
        dh = torch.randn(Bs, S, Wd, generator=g, device=DEV).to(
            torch.bfloat16)
        dh_last = (torch.randn(Bs, Wd, generator=g, device=DEV)
                   if with_last else None)
        _, _, states = rglru_gated(*args, h0, states_every=RGLRU_BWD_STEPS)
        ms = in_turns(timer, {name: through(lib, lambda: rglru_gated_bwd(
            *args, h0, dh, dh_last, states)) for name, lib in libs.items()})
        res = {"shape": [Bs, S, Wd], "ms": ms, **rglru_bwd_work(
            Bs, S, Wd, torch.bfloat16, with_h0, with_last)}
        log(f"[ablate] {json.dumps(res)}")
        del args, h0, dh, dh_last, states
    torch.cuda.empty_cache()


def mamba_bwd_shapes() -> tuple:
    """(B, S, Di, N, dh_last, timed): falcon-mamba-7b's training shape (8 x
    1024 by 8192 x 16, no dh_last, as the model runs it), then ragged ones,
    each N of {4, 8, 16}: S not a multiple of the 16-step chunk, Di * N not
    a multiple of the 512-element block, with and without dh_last; the
    last a chain of 32 chunks over two element blocks, whose blocks wait
    for their predecessors while those run."""
    fm = get_config("falcon-mamba-7b")
    return ((8, 1024, fm.d_inner, fm.ssm_state, False, True),
            (1, 45, 130, 4, True, False), (2, 33, 24, 8, False, False),
            (1, 70, 130, 16, True, False), (2, 1, 16, 4, True, False),
            (1, 500, 40, 16, True, False))


def kernels_mamba_bwd(timer: Timer, g) -> list:
    """The Mamba scan's backward against ``mamba_scan_bwd_ref`` on the card
    at ``mamba_bwd_shapes``, bf16 and fp32 inputs (fp32 outputs), within
    TOL of the inputs' dtype; a second launch must give the same bits.
    Timed in fp32 (the model's da and dbx) at the training shape beside its
    bound and the plain version, and its launches apart
    (``launch_times``; fold includes its scratch's memset); no PyTorch call
    computes a linear recurrence's backward."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for Bs, S, Di, N, with_last, timed in mamba_bwd_shapes():
            da = (torch.rand(Bs, S, Di, N, generator=g, device=DEV) * 0.49
                  + 0.5).to(dt)
            dbx = (torch.randn(Bs, S, Di, N, generator=g, device=DEV)
                   * 0.1).to(dt)
            c = torch.randn(Bs, S, N, generator=g, device=DEV).to(dt)
            dy = torch.randn(Bs, S, Di, generator=g, device=DEV).to(dt)
            dh_last = (torch.randn(Bs, Di, N, generator=g, device=DEV)
                       if with_last else None)
            n0 = mamba_scan_bwd.launches
            got = mamba_scan_bwd(da, dbx, c, dy, dh_last)
            again = mamba_scan_bwd(da, dbx, c, dy, dh_last)
            if mamba_scan_bwd.launches != n0 + 2:
                raise AssertionError("mamba_scan_bwd: not one launch a call")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("mamba_scan_bwd: two launches differ")
            del again
            want = mamba_scan_bwd_ref(da, dbx, c, dy, dh_last)
            errs, bad = {}, []
            for n, a, b in zip(("dda", "ddbx", "dc"), got, want):
                try:
                    errs[n] = close(a, b, TOL[dt])
                except AssertionError as e:
                    bad.append(f"{n}: {e}")
            if bad:
                raise AssertionError(f"mamba_scan_bwd {Bs}x{S}x{Di}x{N} "
                                     f"{dt}: {'; '.join(bad)}")
            del got, want
            case = {"shape": [Bs, S, Di, N], "dtype": str(dt)[6:],
                    "dh_last": with_last, "tol": TOL[dt],
                    "max_abs_err": max(errs.values()), "err": errs}
            if timed and dt == torch.float32:
                es = esize(dt)
                n = da.numel()
                # da, dbx, c, dy read; dda, ddbx (fp32) and dc written
                nbytes = (2 * n + Bs * S * (N + Di)) * es + \
                    (2 * n + Bs * S * N) * 4

                def call(marks=None):
                    return mamba_scan_bwd(da, dbx, c, dy, dh_last, marks)

                case.update(
                    ms=timer.ms(call), split_ms=launch_times(
                        timer, call, ("fold", "grads", "dc")),
                    plain_ms=timer.ms(lambda: mamba_scan_bwd_ref(
                        da, dbx, c, dy, dh_last), reps=3),
                    library_ms=None,
                    # ~8 operations an element: the recomputed state, the
                    # reverse step, dda, and dc's product and sum
                    **bound(nbytes, 8 * n, torch.float32))
            log(f"[train] mamba_scan_bwd {case}")
            cases.append(case)
            del da, dbx, c, dy, dh_last
            torch.cuda.empty_cache()
    return cases


def kernels_rmsnorm_bwd(timer: Timer, rn) -> list:
    """The RMSNorm backward (dx, dw) against ``rmsnorm_bwd_ref`` in bf16
    and fp32, within TOL: qwen2-7b's training rows (8 x 1024 by 3584), 8192
    x 2048, a ragged d and fewer rows than the kernel's blocks.  Timed at
    qwen2-7b's rows in bf16 beside the plain version and ``F.rms_norm``'s
    autograd backward, which the port never calls."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for i, (n, dd) in enumerate(((8192, 3584), (8192, 2048), (300, 130),
                                     (7, 4096))):
            x, dy = rn(n, dd, dt=dt), rn(n, dd, dt=dt)
            w = (rn(dd, dt=torch.float32) * 0.1 + 1.0).to(dt)
            dx, dw = rmsnorm_bwd(x, w, dy)
            rdx, rdw = rmsnorm_bwd_ref(x, w, dy)
            errs = {"dx": close(dx, rdx, TOL[dt]), "dw": close(dw, rdw, TOL[dt])}
            case = {"shape": [n, dd], "dtype": str(dt)[6:], "tol": TOL[dt],
                    "max_abs_err": max(errs.values()), "err": errs}
            if dt == torch.bfloat16 and i == 0:
                xl = x.detach().requires_grad_()
                wl = w.detach().requires_grad_()
                yl = F.rms_norm(xl, (dd,), wl, eps=1e-6)
                es = esize(dt)
                case.update(
                    ms=timer.ms(lambda: rmsnorm_bwd(x, w, dy)),
                    plain_ms=timer.ms(lambda: rmsnorm_bwd_ref(x, w, dy)),
                    library_ms=timer.ms(lambda: torch.autograd.grad(
                        yl, (xl, wl), dy, retain_graph=True)),
                    # x and dy read, dx written, w read and dw written;
                    # ~10 fp32 operations an element
                    **bound((3 * n * dd + 2 * dd) * es, 10 * n * dd,
                            torch.float32))
                del xl, wl, yl
            log(f"[train] rmsnorm_bwd {case}")
            cases.append(case)
    return cases


def train_attn_calls(cfg, seq: int) -> list:
    """(Sq, Skv, causal, window, chunk) of each attention call of one
    training forward over ``seq`` tokens (after an ``img_tokens`` config's
    image positions), recompute aside: every attention layer's
    self-attention, and an encoder-decoder's cross attention (a decoder
    layer's, over the frames) and encoder layers (unmasked)."""
    pos = seq + cfg.img_tokens
    calls = [(pos, pos, True, cfg.attn_window if k == "attn_local" else 0,
              cfg.attn_chunk if k == "attn_chunk" else 0)
             for k in cfg.layer_kinds() if k.startswith("attn")]
    if cfg.is_encdec:
        calls += [(pos, cfg.enc_seq, False, 0, 0)] * cfg.n_layers
        calls += [(cfg.enc_seq, cfg.enc_seq, False, 0, 0)] * cfg.n_enc_layers
    return calls


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int,
                  chunk: int) -> int:
    """(query, key) pairs of one head that a call sees: queries and keys
    from position 0, the causal mask cut by the window or the chunk."""
    if not causal:
        return Sq * Skv
    return sum(min(i + 1, window or i + 1, i % chunk + 1 if chunk else i + 1)
               for i in range(Sq))


def train_flops(model, batch: int, seq: int) -> float:
    """A training step's operations: 6 per parameter and token of every
    matrix the tokens go through (the layers' at every position, the
    routed experts' at top_k of n_experts, cross attention's K and V and
    the encoder's at the frames, ``img_proj`` at the image tokens, the
    unembedding; the embedding is a lookup; the scans' elementwise work is
    left out), plus each attention call's products, 4 * D a visible
    (query, key) pair forward and 2.5x that backward.  A recompute is not
    counted: it is work the step does, not work it needs."""
    cfg = model.cfg
    pos = seq + cfg.img_tokens
    dec = enc = 0.0
    for name, p in model.layers.named_parameters():
        n = p.numel() * (cfg.top_k / cfg.n_experts
                         if ".moe.w_" in f".{name}" else 1)
        if ".cross.wk" in name or ".cross.wv" in name:
            enc += n
        else:
            dec += n
    if cfg.is_encdec:
        enc += sum(p.numel() for p in model.enc.layers.parameters())
    dense = pos * (dec + cfg.d_model * cfg.vocab) + cfg.enc_seq * enc \
        + cfg.img_tokens * cfg.d_model ** 2
    attn = sum(3.5 * 4 * cfg.resolved_head_dim * cfg.n_heads
               * visible_pairs(*call) for call in train_attn_calls(cfg, seq))
    return 6.0 * batch * dense + batch * attn


def expected_train_launches(cfg) -> dict:
    """One training step's launches by kernel: each forward kernel once,
    and once more where ``remat`` recomputes it (every layer's, in every
    group; not the final norms); each backward kernel once.  RMSNorm
    configs only launch norms (LayerNorm is eager): two a layer outside the
    ssm family and one inside, one more a decoder layer of an
    encoder-decoder (before its cross attention), two an encoder layer, and
    the final norms (the encoder's and the model's).  Attention: every call
    of ``train_attn_calls``.  The RG-LRU and Mamba layers one each."""
    kinds = cfg.layer_kinds()
    rms = cfg.norm == "rmsnorm"
    layer_norms = rms * (len(kinds) * ((1 if cfg.family == "ssm" else 2)
                                       + cfg.is_encdec)
                         + 2 * cfg.n_enc_layers * cfg.is_encdec)
    final_norms = rms * (1 + cfg.is_encdec)
    attn = len(train_attn_calls(cfg, 1))
    rg, mb = kinds.count("rglru"), kinds.count("mamba")
    fwd = 2 if cfg.remat in REMAT_POLICIES else 1
    counts = dict.fromkeys(KERNELS, 0)
    counts.update(rmsnorm=fwd * layer_norms + final_norms,
                  rmsnorm_bwd=layer_norms + final_norms,
                  flash_attention=fwd * attn, flash_attention_bwd=attn,
                  rglru_gated=fwd * rg, rglru_gated_bwd=rg,
                  mamba_scan=fwd * mb, mamba_scan_bwd=mb)
    return counts


def train_impls(cfg, batch: int, seq: int) -> tuple:
    """({forward kernel: launches}, {backward kernel: launches}) of a
    training step's attention in bf16: each call of ``train_attn_calls`` on
    the prefill plan with the log-sum-exp (twice under ``remat``) and on
    ``plan_bwd``'s kernel."""
    D, dt = cfg.resolved_head_dim, torch.bfloat16
    rec = 2 if cfg.remat in REMAT_POLICIES else 1
    fwd, bwd = {}, {}
    for Sq, Skv, *_ in train_attn_calls(cfg, seq):
        f = flash_plan(batch, Sq, cfg.n_heads, cfg.n_kv_heads, D, dt, Skv,
                       lse=True).impl
        b = plan_bwd(batch, Sq, Skv, cfg.n_heads, cfg.n_kv_heads, D, dt)
        fwd[f] = fwd.get(f, 0) + rec
        bwd[b] = bwd.get(b, 0) + 1
    return fwd, bwd


def grads_finite_nonzero(model) -> dict:
    """Per parameter: a gradient, all finite, not all zero."""
    bad = {n: "none" if p.grad is None else
           "non-finite" if not bool(torch.isfinite(p.grad).all()) else
           "zero" if not bool(p.grad.any()) else None
           for n, p in model.named_parameters()}
    return {n: why for n, why in bad.items() if why}


def train_batch(cfg, batch: int, seq: int, step: int, seed: int = 1) -> dict:
    """The pipeline's batch ``step`` on the card, with the image embeddings
    or frames the config takes, as ``train_loop`` draws them."""
    data = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed))
    return device_batch(cfg, data.global_batch_at(step), torch.device(DEV))


def train_cfg(arch: str, layers: int, remat: str = "none"):
    """``arch`` at its published widths, cut to ``layers`` layers (an
    encoder-decoder's encoder to as many, at most its own), under
    ``remat``."""
    full = get_config(arch)
    kw = dict(n_layers=layers, remat=remat)
    if full.is_encdec:
        kw["n_enc_layers"] = min(layers, full.n_enc_layers)
    return dataclasses.replace(full, **kw)


def train_probe() -> None:
    """``--train-probe``: the peak memory of two ``make_train_step`` steps
    of each TRAIN_PROBES entry at each of its depths (an out-of-memory
    error is reported, not raised), and the deepest depth that a line
    through two depths' peaks keeps within PROBE_FIT_GB."""
    for arch, batch, seq, depths, remat in TRAIN_PROBES:
        peaks = {}
        for layers in depths:
            cfg = train_cfg(arch, layers, remat)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                model = Transformer(cfg, DEV, seed=0, trainable=True)
                step, opt_init = make_train_step(model, AdamWConfig(
                    moment_dtype=cfg.moment_dtype))
                opt = opt_init()
                t0 = time.perf_counter()
                for s in range(2):
                    opt, m = step(opt, train_batch(cfg, batch, seq, s))
                    loss = float(m["loss"])
                ms = (time.perf_counter() - t0) * 1e3
                peaks[layers] = torch.cuda.max_memory_allocated() / 1e9
                log(f"[probe] {arch} {remat} {layers} L {batch} x {seq}: "
                    f"peak {peaks[layers]:.2f} GB, 2 steps {ms:.0f} ms, "
                    f"loss {loss:.4f}")
                del model, step, opt, m
            except torch.cuda.OutOfMemoryError:
                log(f"[probe] {arch} {remat} {layers} L {batch} x {seq}: "
                    f"out of memory")
                model = step = opt = m = None
        if len(peaks) == 2:
            (l1, p1), (l2, p2) = sorted(peaks.items())
            per = (p2 - p1) / (l2 - l1)
            fit = int((PROBE_FIT_GB - (p1 - per * l1)) // per)
            log(f"[probe] {arch} {remat} {batch} x {seq}: {per:.3f} GB a "
                f"layer over {p1 - per * l1:.2f} GB: {fit} layers within "
                f"{PROBE_FIT_GB} GB")


def train_run(arch: str, layers: int, batch: int, seq: int,
              lr: float = 1e-3, steps: int = 4, remat: str = "none",
              keep_grads: bool = False) -> dict:
    """One of the slice's main paths: ``make_train_step`` on ``arch`` at
    ``layers`` layers (published widths, bf16, seeded random weights; an
    encoder-decoder's encoder cut alike, ``train_cfg``) under ``remat`` for
    ``steps`` steps of batch x seq tokens (and the image embeddings or
    frames the config takes) at learning rate ``lr``, each on the
    pipeline's next batch.  The counts are set to 0 just
    before the steps and read just after; each step's launches must be
    exactly ``expected_train_launches`` (the recomputed forwards included;
    all RMSNorms ``vector``, the attention forwards on the plan's prefill
    kernel with the log-sum-exp and the backwards on ``plan_bwd``'s:
    ``tc``, recurrentgemma-2b's windowed D 256 included), every parameter's
    gradient finite and non-zero after each step, and the loss finite and
    falling or flat (the last step's no higher than the first's).
    Then one more step under the profiler (device ms by kernel, the idle
    share) and AdamW's update alone, timed on that step's gradients.
    ``keep_grads``: the first step's gradients are returned on the host
    under ``first_grads`` (for ``remat_compare``)."""
    full = get_config(arch)
    cfg = train_cfg(arch, layers, remat)
    model = Transformer(cfg, DEV, seed=0, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    adam_cfg = AdamWConfig(lr=lr, moment_dtype=cfg.moment_dtype)
    step, opt_init = make_train_step(model, adam_cfg)
    opt = opt_init()
    batches = [train_batch(cfg, batch, seq, s) for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expect = expected_train_launches(cfg)
    fwd_want, bwd_want = train_impls(cfg, batch, seq)
    reset_counts()
    metrics, step_ms, per_step, missing = [], [], [], []
    first_grads = None
    for s in range(steps):
        before = read_counts()
        impls = dict(flash_attention.impl_launches)
        bwd0 = dict(flash_attention_bwd.impl_launches)
        lse0, var0 = flash_attention.lse_launches, dict(
            fused_rmsnorm.variant_launches)
        t0 = time.perf_counter()
        opt, m = step(opt, batches[s])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
        now = read_counts()
        got = {k: now[k] - before[k] for k in KERNELS}
        per_step.append(got)
        if got != expect:
            raise AssertionError(f"{arch} train step {s}: launches {got} != "
                                 f"{expect}")
        fwd = {n: c - impls[n]
               for n, c in flash_attention.impl_launches.items()}
        bwd = {n: c - bwd0[n]
               for n, c in flash_attention_bwd.impl_launches.items()}
        vec = fused_rmsnorm.variant_launches["vector"] - var0["vector"]
        if fwd != {n: fwd_want.get(n, 0) for n in fwd} or \
                bwd != {n: bwd_want.get(n, 0) for n in bwd} or \
                flash_attention.lse_launches - lse0 != \
                expect["flash_attention"] or vec != expect["rmsnorm"]:
            raise AssertionError(f"{arch} train step {s}: forwards {fwd}, "
                                 f"backwards {bwd} (want {fwd_want} / "
                                 f"{bwd_want}), "
                                 f"{flash_attention.lse_launches - lse0} "
                                 f"with lse, {vec} vector norms")
        missing.append(grads_finite_nonzero(model))
        if keep_grads and s == 0:
            first_grads = {n: p.grad.cpu() for n, p in
                           model.named_parameters()}
    launches = read_counts()
    flash_impls = dict(flash_attention.impl_launches)
    bwd_impls = dict(flash_attention_bwd.impl_launches)
    lse_launches = flash_attention.lse_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # after the counted steps: one more step under the profiler, then
    # AdamW alone on that step's gradients (it moves the weights again)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, _ = step(opt, batches[0])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    breakdown = device_breakdown(prof.events(), host_ms)
    bwd_split = launch_split(prof.events())   # [launches, ms] by launch
    del prof
    params = dict(model.named_parameters())
    grads = {n: p.grad for n, p in params.items()}
    adamw_ms = Timer().ms(lambda: adamw_update(params, grads, opt["adam"],
                                               adam_cfg), reps=3)
    del grads
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    flops = train_flops(model, batch, seq)
    steady = statistics.mean(step_ms[1:])
    bound_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "published_layers": full.n_layers, "remat": remat,
           "enc_layers": cfg.n_enc_layers if cfg.is_encdec else None,
           "cut": f"depth {cfg.n_layers} of {full.n_layers} layers, "
                  f"{batch} x {seq} tokens: the 80 GB card",
           "positions": seq + cfg.img_tokens,
           "dtype": cfg.param_dtype, "params": n_params, "batch": batch,
           "seq": seq, "steps": steps, "lr": lr, "loss": losses,
           "grad_norm": gnorms, "first_step_ms": step_ms[0],
           "step_ms": step_ms[1:], "steady_step_ms": steady,
           "tokens_per_s": batch * seq / steady * 1e3,
           "positions_per_s": batch * (seq + cfg.img_tokens) / steady * 1e3,
           "step_flops": flops, "step_bound_ms": bound_ms,
           "share_of_bound": bound_ms / steady, "peak_mem_gb": peak_gb,
           "launches": launches, "launches_per_step": per_step[0],
           "flash_impls": flash_impls, "bwd_impls": bwd_impls,
           "lse_launches": lse_launches, "flash_impls_per_step": fwd_want,
           "bwd_impls_per_step": bwd_want,
           "params_without_finite_nonzero_grad": missing,
           "profiled_step": {k: breakdown[k] for k in (
               "device_ms", "idle_share", "by_kernel_ms")},
           "profiled_step_bwd_launch_ms": {n: ms for n, (_, ms) in
                                           bwd_split.items()},
           "profiled_step_bwd_launches": {n: k for n, (k, _) in
                                          bwd_split.items()},
           "profiled_step_host_ms": host_ms, "adamw_update_ms": adamw_ms}
    log(f"[train] {arch} {json.dumps(res)}")
    if any(missing):
        raise AssertionError(f"train {arch}: parameters without a finite "
                             f"non-zero gradient: {missing}")
    if not all(np.isfinite(losses)) or not losses[-1] <= losses[0]:
        raise AssertionError(f"train {arch}: loss {losses} not finite and "
                             f"falling or flat")
    del model, opt, step, batches, metrics
    torch.cuda.empty_cache()
    if first_grads is not None:
        res["first_grads"] = first_grads
    return res


def eager_dbx(dt, bmat, xc):
    """``dt (x) B * xc`` as the Mamba block computed it before
    ``DiscretiseBx``: autograd of the in-place product keeps a clone of
    ``dt (x) B``."""
    return (dt[..., None] * bmat[:, :, None, :].float()).mul_(
        xc[..., None].float())


def dbx_peaks(layers: int = 2, batch: int = 8, seq: int = 1024) -> dict:
    """falcon-mamba-7b's peak memory over one loss and backward at
    ``layers`` layers (published widths, bf16) with ``DiscretiseBx`` and
    with the eager product it replaced (the clone), on the same weights
    and batch; their losses must be equal."""
    from repro_torch.models import mamba as mamba_mod
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=layers)
    model = Transformer(cfg, DEV, seed=0, trainable=True)
    data = train_batch(cfg, batch, seq, 0)
    out = {}
    try:
        for form in ("DiscretiseBx", "eager"):
            if form == "eager":     # shadows Function.apply on the class
                mamba_mod.DiscretiseBx.apply = eager_dbx
            for p in model.parameters():
                p.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss = loss_fn(model, data)[0]
            loss.backward()
            torch.cuda.synchronize()
            out[form] = {"loss": loss.item(),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "peak_over_weights_gb": (
                             torch.cuda.max_memory_allocated() - base) / 1e9}
            del loss
    finally:
        if "apply" in vars(mamba_mod.DiscretiseBx):
            del mamba_mod.DiscretiseBx.apply
    del model, data
    torch.cuda.empty_cache()
    res = {"layers": layers, "tokens": [batch, seq], **out,
           "per_layer_gb": (out["eager"]["peak_gb"]
                            - out["DiscretiseBx"]["peak_gb"]) / layers}
    log(f"[train] falcon-mamba-7b dt*B*xc peaks {json.dumps(res)}")
    if out["eager"]["loss"] != out["DiscretiseBx"]["loss"]:
        raise AssertionError(f"DiscretiseBx changed the loss: {out}")
    return res


@contextlib.contextmanager
def plain_kernels():
    """Inside: the model path's RMSNorm, attention, RG-LRU and Mamba scan
    take their plain versions on the card (autograd differentiates them),
    for the rounding floor of the gradient check only."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import common as common_mod
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import rglru as rglru_mod
    saved = (attn_mod.flash_attention, common_mod.fused_rmsnorm,
             rglru_mod.rglru_gated, mamba_mod.mamba_scan)
    attn_mod.flash_attention = attention_ref
    common_mod.fused_rmsnorm = rmsnorm_ref
    rglru_mod.rglru_gated = rglru_gated_ref
    mamba_mod.mamba_scan = mamba_scan_ref
    try:
        yield
    finally:
        (attn_mod.flash_attention, common_mod.fused_rmsnorm,
         rglru_mod.rglru_gated, mamba_mod.mamba_scan) = saved


def loss_grads(model, batch) -> tuple:
    """(loss, {name: gradient}), the gradients in the parameters' dtype
    (rel_rms compares them in fp64, a leaf at a time)."""
    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model, batch)[0]
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def grad_check(arch: str, layers: int, batch: int, seq: int,
               remat: str = "none") -> dict:
    """One step's gradients of ``arch`` at its widths and ``layers`` layers
    (``train_cfg``) under ``remat``: the bf16 kernel path (exact launches,
    the recomputed forwards included, the plan's backward kernels)
    against the fp32 gradients of the same weights and batch (the fp32
    kernel path), leaf by leaf, by the rule ``serve_check`` applies to
    logits: relative RMS error within FLOOR_MULT times the bf16 rounding
    floor, the same distance of the bf16 plain path (autograd through
    ``attention_ref``, ``rmsnorm_ref``, ``rglru_gated_ref`` and
    ``mamba_scan_ref``, on the card)."""
    cfg = train_cfg(arch, layers, remat)
    data = train_batch(cfg, batch, seq, 0)
    model = Transformer(cfg, DEV, seed=5, trainable=True)
    _, bwd_want = train_impls(cfg, batch, seq)
    reset_counts()
    loss_k, g_k = loss_grads(model, data)
    counts = read_counts()
    bwd = {n: c for n, c in flash_attention_bwd.impl_launches.items() if c}
    if counts != expected_train_launches(cfg) or bwd != bwd_want:
        raise AssertionError(f"grad check {arch}: launches {counts}, "
                             f"backward {flash_attention_bwd.impl_launches}")
    with plain_kernels():
        reset_counts()
        loss_p, g_p = loss_grads(model, data)
        if any(read_counts().values()):
            raise AssertionError("grad check: the plain path launched a "
                                 "kernel")
    model32 = Transformer(dataclasses.replace(cfg, param_dtype="float32"),
                          DEV, seed=5, trainable=True)
    model32.load_state_dict({n: t.float()
                             for n, t in model.state_dict().items()})
    del model
    loss_32, g_32 = loss_grads(model32, data)
    del model32
    leaves = {}
    for n in g_32:
        err, floor = rel_rms(g_k[n], g_32[n]), rel_rms(g_p[n], g_32[n])
        leaves[n] = {"kernel_vs_fp32": err, "plain_bf16_vs_fp32": floor,
                     "ratio": err / floor if floor else float("inf")}
    worst = max(leaves, key=lambda n: leaves[n]["ratio"])
    res = {"arch": cfg.name, "layers": cfg.n_layers, "remat": remat,
           "enc_layers": cfg.n_enc_layers if cfg.is_encdec else None,
           "tokens": [batch, seq], "positions": seq + cfg.img_tokens,
           "backward_impls": bwd,
           "loss": {"bf16_kernels": loss_k, "bf16_plain": loss_p,
                    "fp32": loss_32},
           "limit_ratio": FLOOR_MULT, "worst_leaf": worst,
           "worst_ratio": leaves[worst]["ratio"], "leaves": leaves}
    log(f"[train] grad check {json.dumps(res)}")
    bad = {n: v for n, v in leaves.items() if not v["ratio"] <= FLOOR_MULT}
    if bad:
        raise AssertionError(f"grad check {arch}: leaves beyond "
                             f"{FLOOR_MULT} x the bf16 floor: {bad}")
    del g_k, g_p, g_32, data
    torch.cuda.empty_cache()
    return res


def tiny_run(name: str, **kw) -> TrainRunConfig:
    """tests/test_system.py's ``_tiny_run`` on the card: reduced
    stablelm-1.6b in fp32."""
    cfg = dataclasses.replace(get_reduced("stablelm-1.6b"),
                              param_dtype="float32")
    defaults = dict(cfg=cfg, steps=24, global_batch=4, seq_len=32, lr=2e-3,
                    save_every=8, log_every=100,
                    ckpt_dir=str(TRAIN_DIR / name), device=DEV)
    defaults.update(kw)
    return TrainRunConfig(**defaults)


def reduced_recurrent_check(arch: str) -> dict:
    """``arch``'s reduced config in fp32 on the card: one loss and backward
    through the kernels (exact launches: the scans' backward kernels,
    recurrentgemma-2b's window on ``simt``) against the CPU's plain path on
    the same weights and batch, every gradient leaf within
    REDUCED_GRAD_RTOL; then ``train_loop`` for 30 steps, the loss falling."""
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    model = Transformer(cfg, DEV, seed=3, trainable=True)
    cpu = Transformer(cfg, "cpu", seed=3, trainable=True)
    cpu.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    data = train_batch(cfg, 2, 64, 0)
    reset_counts()
    loss_k, g_k = loss_grads(model, data)
    counts = read_counts()
    if counts != expected_train_launches(cfg):
        raise AssertionError(f"{arch} reduced: launches {counts} != "
                             f"{expected_train_launches(cfg)}")
    loss_c, g_c = loss_grads(cpu, {k: v.cpu() for k, v in data.items()})
    errs = {n: rel_rms(g_k[n].cpu(), g_c[n]) for n in g_c
            if bool(g_c[n].any())}
    worst = max(errs, key=errs.get)
    h = train_loop(TrainRunConfig(cfg=cfg, steps=30, global_batch=8,
                                  seq_len=64, lr=3e-3, log_every=100,
                                  device=DEV), log=lambda *a: None
                   )["history"]["loss"]
    res = {"launches": counts, "loss": {"cuda": loss_k, "cpu": loss_c},
           "worst_leaf": worst, "worst_rel_rms": errs[worst],
           "tol": REDUCED_GRAD_RTOL, "train_loss": [h[0], h[-1]]}
    if not abs(loss_k - loss_c) <= 1e-5 * abs(loss_c) or \
            not errs[worst] <= REDUCED_GRAD_RTOL:
        raise AssertionError(f"{arch} reduced on the card vs the CPU: {res}")
    if not h[-1] < h[0]:
        raise AssertionError(f"{arch} reduced: loss {h} not falling")
    del model, cpu
    return res


def reference_training_tests() -> dict:
    """tests/test_system.py's four training tests through the port's
    ``train_loop`` on the card (its kernels: fp32 flash on ``simt`` with
    the log-sum-exp and its backward; qwen2-7b's RMSNorms), then the
    reduced recurrentgemma-2b and falcon-mamba-7b trained on the card in
    fp32 (``reduced_recurrent_check``)."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    quiet = lambda *a: None   # noqa: E731
    res = {}
    t0 = time.perf_counter()
    h = train_loop(tiny_run("learn", steps=60, global_batch=8, seq_len=64,
                            lr=3e-3, ckpt_dir=None, log_every=20),
                   log=quiet)["history"]["loss"]
    res["learns"] = {"loss": h, "drop": h[0] - h[-1], "need": 0.7}
    if not h[-1] < h[0] - 0.7:
        raise AssertionError(f"training_learns: {h}")
    out_a = train_loop(tiny_run("a"), log=quiet)
    inj = FaultInjector(fail_at_steps=[13])
    out_b = train_loop(tiny_run("b"), injector=inj, log=quiet)
    if out_b["restarts"] != 1 or inj.fired != [13]:
        raise AssertionError(f"restart: {out_b['restarts']} restarts, fired "
                             f"{inj.fired}")
    pa = out_a["state"]["model"].state_dict()
    pb = out_b["state"]["model"].state_dict()
    diff = max(close(pb[n], pa[n], 1e-5) for n in pa)
    res["restart"] = {"restarts": out_b["restarts"], "fired": inj.fired,
                      "max_abs_param_diff": diff, "tol": 1e-5}
    h = train_loop(tiny_run("gc", steps=60, global_batch=8, seq_len=64,
                            lr=3e-3, grad_compression=True, ckpt_dir=None),
                   log=quiet)["history"]["loss"]
    res["grad_compression_learns"] = {"loss": h, "drop": h[0] - h[-1],
                                      "need": 0.6}
    if not h[-1] < h[0] - 0.6:
        raise AssertionError(f"grad compression: {h}")
    cfg = dataclasses.replace(get_reduced("qwen2-7b"), param_dtype="float32")
    base = TrainRunConfig(cfg=cfg, steps=6, global_batch=8, seq_len=32,
                          lr=1e-3, log_every=1, device=DEV)
    l1 = train_loop(base, log=quiet)["history"]["loss"]
    l4 = train_loop(dataclasses.replace(base, microbatches=4),
                    log=quiet)["history"]["loss"]
    gap = max(abs(a - b) for a, b in zip(l1, l4))
    res["microbatches"] = {"loss_1": l1, "loss_4": l4, "max_diff": gap,
                           "tol": "2e-4 abs + rel"}
    if not np.allclose(l4, l1, rtol=2e-4, atol=2e-4):
        raise AssertionError(f"microbatches: {l1} vs {l4}")
    for arch in ("recurrentgemma-2b", "falcon-mamba-7b"):
        res[f"{arch} reduced fp32"] = reduced_recurrent_check(arch)
    res["seconds"] = time.perf_counter() - t0
    log(f"[train] reference tests {json.dumps(res)}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return res


def remat_compare(runs: dict, check: dict) -> dict:
    """REMAT_ARCH's runs under each ``remat`` policy against its run
    without: the same weights and batches, so the first step's loss and
    gradients must agree.  Whether their bits are equal, and the relative
    distance, held within the grad check's margin over the bf16 floor:
    (FLOOR_MULT - 1) times the smallest floor of a leaf in ``check`` (the
    config's grad check without remat).  The peaks must fall from none to
    selective to full; the later losses are reported."""
    names = {p: next(n for n, r in runs.items() if r["arch"] == REMAT_ARCH
                     and r["remat"] == p) for p in ("none",) + REMAT_POLICIES}
    base = runs[names["none"]]
    limit = (FLOOR_MULT - 1) * min(v["plain_bf16_vs_fp32"]
                                   for v in check["leaves"].values())
    out = {"arch": REMAT_ARCH, "limit_rel": limit, "none": {
        k: base[k] for k in ("peak_mem_gb", "steady_step_ms", "loss")}}
    for policy in REMAT_POLICIES:
        run = runs[names[policy]]
        equal, dist = True, {}
        for n, g in base["first_grads"].items():
            h = run["first_grads"][n]
            equal &= torch.equal(g, h)
            dist[n] = rel_rms(h.to(DEV), g.to(DEV))
        worst = max(dist, key=dist.get)
        gap = abs(run["loss"][0] - base["loss"][0]) / abs(base["loss"][0])
        out[policy] = {
            "losses_equal_bits": run["loss"] == base["loss"],
            "first_loss_rel_gap": gap, "grads_equal_bits": equal,
            "worst_leaf": worst, "worst_rel_rms": dist[worst],
            **{k: run[k] for k in ("peak_mem_gb", "steady_step_ms", "loss")},
            "step_ms_over_none": run["steady_step_ms"]
            / base["steady_step_ms"]}
        if not (dist[worst] <= limit and gap <= limit):
            raise AssertionError(f"remat {policy} vs none: {out[policy]}")
    for name, r in runs.items():
        if name != names["none"]:       # phase 10 reads the plain run's
            r.pop("first_grads", None)
    log(f"[train] remat compare {json.dumps(out)}")
    peaks = [out[p]["peak_mem_gb"] for p in ("none", "selective", "full")]
    if not peaks[0] > peaks[1] > peaks[2]:
        raise AssertionError(f"remat peaks none, selective, full: {peaks}")
    return out


def remat_costs() -> dict:
    """The bytes a training forward of REMAT_ARCH leaves for its backward
    (allocated after ``loss_fn`` less before) at REMAT_DEPTHS layers and
    REMAT_TOKENS, under each policy: the slope over the layers, a token,
    in d_model words of the param dtype (the unit of the cost model's
    ``_ACT_SAVE_FACTOR``, 14 / 6 / 1), and what stays beside the layers
    (the logits, their log-softmax)."""
    batch, seq = REMAT_TOKENS
    out = {}
    for policy in ("none",) + REMAT_POLICIES:
        saved = {}
        for layers in REMAT_DEPTHS:
            cfg = train_cfg(REMAT_ARCH, layers, policy)
            model = Transformer(cfg, DEV, seed=0, trainable=True)
            data = train_batch(cfg, batch, seq, 0)
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            loss = loss_fn(model, data)[0]
            torch.cuda.synchronize()
            saved[layers] = torch.cuda.memory_allocated() - m0
            loss.backward()
            del model, data, loss
            torch.cuda.empty_cache()
        (l1, s1), (l2, s2) = sorted(saved.items())
        per_layer = (s2 - s1) / (l2 - l1)
        out[policy] = {
            "saved_gb": {str(k): v / 1e9 for k, v in saved.items()},
            "per_layer_gb": per_layer / 1e9,
            "outside_layers_gb": (s1 - per_layer * l1) / 1e9,
            "words_per_token_layer": per_layer / (batch * seq * cfg.d_model
                                                  * esize(torch.bfloat16))}
    res = {"arch": REMAT_ARCH, "tokens": [batch, seq], **out}
    log(f"[train] remat costs {json.dumps(res)}")
    return res


def phase_train() -> tuple:
    """Phase 9: (kernel rows, runs).  The kernels first (the backward ones
    and the forward's log-sum-exp; the ``simt`` backward in fp32 at phase
    5's shapes), then the main paths' runs (TRAIN_RUNS), falcon-mamba-7b's
    dt*B*xc peaks, the gradient checks (GRAD_CHECKS), REMAT_ARCH's runs
    held to one another (``remat_compare``) and the reference's training
    tests."""
    timer = Timer()
    g = torch.Generator(device=DEV).manual_seed(4321)

    def rn(*shape, dt):
        return torch.randn(*shape, generator=g, device=DEV).to(dt)

    rows = {"flash_attention_bwd": kernels_flash_bwd(timer, rn)
            + kernels_flash_bwd_fp32(timer, rn),
            "rmsnorm_bwd": kernels_rmsnorm_bwd(timer, rn),
            "rglru_gated_bwd": kernels_rglru_bwd(timer, g),
            "mamba_scan_bwd": kernels_mamba_bwd(timer, g)}
    del timer
    torch.cuda.empty_cache()
    runs = {}
    for arch, layers, batch, seq, lr, steps, remat in TRAIN_RUNS:
        name = f"train {arch} {layers} layers" + (
            f" remat {remat}" if remat != "none" else "")
        runs[name] = train_run(arch, layers, batch, seq, lr, steps, remat,
                               keep_grads=arch == REMAT_ARCH)
    dbx_peaks()
    remat_costs()
    checks = [grad_check(*check) for check in GRAD_CHECKS]
    remat_compare(runs, next(c for c in checks if c["arch"] == REMAT_ARCH
                             and c["remat"] == "none"))
    reference_training_tests()
    return rows, runs


# phase 10: the multi-device launch path on a (1, 1) NCCL mesh of the card.
# Training: phase 9's first run (MESH_TRAIN, its arch, depth, batch, seq,
# lr and steps) through ``train_loop(run, mesh)``, held bit for bit to that
# run; serving: phase 4's qwen2-7b (MESH_SERVE) through ``generate`` on the
# distributed model.  The dry run's two cells (DRYRUN_CELLS) run at full
# size in subprocesses on fake ranks, started when the phase starts.
MESH_TRAIN = ("qwen2-7b", 8, 8, 1024, 1e-3, 4)
MESH_SERVE = ("qwen2-7b", 8, 1024, 32)
DRYRUN_CELLS = (("qwen2-7b", "train_4k", "single"),
                ("dbrx-132b", "decode_32k", "multi"))
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"
DRYRUN_ARGS = ("--cost-mode", "scanned")   # every layer traced once
DRYRUN_LIMIT_S = 600


def start_dryruns() -> list:
    """The dry run's cells, each ``python -m repro_torch.launch.dryrun``
    in its own process (a fake process group: no card)."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        logf = open(DRYRUN_OUT / f"{arch}__{shape}__{mesh}.log", "w")
        procs.append(((arch, shape, mesh), logf, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, *DRYRUN_ARGS, "--out",
             str(DRYRUN_OUT)], cwd=ROOT, env=env,
            stdout=logf, stderr=subprocess.STDOUT), time.perf_counter()))
    return procs


def finish_dryruns(procs) -> dict:
    """Each cell's artifact once its process ends: per-device GB against
    the card's 80, FLOPs, collective bytes by kind, the wall time to
    trace.  A cell that fails or outlives DRYRUN_LIMIT_S fails the run."""
    out = {}
    try:
        for (arch, shape, mesh), logf, proc, t0 in procs:
            left = DRYRUN_LIMIT_S - (time.perf_counter() - t0)
            rc = proc.wait(timeout=max(left, 1))
            wall = time.perf_counter() - t0
            logf.close()
            path = DRYRUN_OUT / f"{arch}__{shape}__{mesh}.json"
            art = json.loads(path.read_text()) if path.exists() else {}
            if rc != 0 or art.get("status") != "ok":
                why = art.get("error") or art.get("reason", "")
                raise AssertionError(f"dry run {arch} {shape} {mesh}: rc "
                                     f"{rc}, {art.get('status')}, "
                                     f"{why[-2000:]}")
            mem = art["memory"]
            res = {"arch": arch, "shape": shape, "mesh": mesh,
                   "chips": art["chips"],
                   "argument_gb": mem["argument_size_bytes"] / 1e9,
                   "temp_gb": mem["temp_size_bytes"] / 1e9,
                   "per_device_gb": mem["peak_bytes"] / 1e9,
                   "fits_80gb": mem["peak_bytes"] <= 80e9,
                   "flops": art["cost"]["flops"],
                   "bytes_accessed": art["cost"]["bytes accessed"],
                   "collective_bytes": art["collectives"],
                   "kernels": art["kernels"], "trace_s": art["trace_s"],
                   "wall_s": wall, "counts": art["counts"]}
            log(f"[mesh] dryrun {json.dumps(res)}")
            out[f"{arch} {shape} {mesh}"] = res
    finally:
        for _, logf, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    return out


def quiet(*a) -> None:
    pass


def mesh_train(mesh, plain: dict) -> dict:
    """MESH_TRAIN through ``train_loop(run, mesh)``: one step for the
    first step's gradients (left in each parameter's ``.grad``), then the
    run's steps, counts set to 0 before each and read after.  The losses
    and the gradients must equal ``plain`` (phase 9's run) bit for bit, and
    the launches be ``expected_train_launches`` a step, on the same
    kernels."""
    arch, layers, batch, seq, lr, steps = MESH_TRAIN
    cfg = train_cfg(arch, layers)
    run = TrainRunConfig(cfg=cfg, steps=1, global_batch=batch, seq_len=seq,
                         lr=lr, log_every=1)
    expect = expected_train_launches(cfg)
    fwd_want, bwd_want = train_impls(cfg, batch, seq)
    reset_counts()
    out = train_loop(run, mesh, log=quiet)
    got = read_counts()
    differ = [n for n, p in out["state"]["model"].named_parameters()
              if not torch.equal(p.grad.to_local().cpu(),
                                 plain["first_grads"][n])]
    del out
    torch.cuda.empty_cache()
    if got != expect or differ:
        raise AssertionError(f"mesh train, first step: launches {got} "
                             f"(want {expect}); gradients not equal to "
                             f"phase 9's: {differ[:8]}")
    reset_counts()
    out = train_loop(dataclasses.replace(run, steps=steps), mesh, log=quiet)
    launches = read_counts()
    flash_impls = dict(flash_attention.impl_launches)
    bwd_impls = dict(flash_attention_bwd.impl_launches)
    losses = out["history"]["loss"]
    step_ms = [t * 1e3 for t in out["watchdog"].durations]
    del out
    torch.cuda.empty_cache()
    want = {k: v * steps for k, v in expect.items()}
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
           "seq": seq, "steps": steps, "mesh": [1, 1], "backend": "nccl",
           "loss": losses, "plain_loss": plain["loss"],
           "losses_equal_bits": losses == plain["loss"],
           "first_grads_equal_bits": not differ,
           "step_ms": step_ms, "steady_step_ms": statistics.mean(step_ms[1:]),
           "plain_steady_step_ms": plain["steady_step_ms"],
           "plain_step_ms": plain["step_ms"], "launches": launches,
           "flash_impls": flash_impls, "bwd_impls": bwd_impls}
    res["step_ms_over_plain"] = res["steady_step_ms"] / \
        plain["steady_step_ms"]
    log(f"[mesh] train {json.dumps(res)}")
    if launches != want or losses != plain["loss"] or \
            flash_impls != {n: fwd_want.get(n, 0) * steps
                            for n in flash_impls} or \
            bwd_impls != {n: bwd_want.get(n, 0) * steps for n in bwd_impls}:
        raise AssertionError(f"mesh train: launches {launches} (want "
                             f"{want}), flash {flash_impls}, backward "
                             f"{bwd_impls}, losses {losses} vs phase 9's "
                             f"{plain['loss']}")
    return res


def mesh_serve(mesh) -> dict:
    """MESH_SERVE's greedy run as phase 4 draws it (weights and prompts
    from one generator seeded 0), with no mesh, then again on the same
    model distributed onto ``mesh`` through the sharded prefill and decode
    steps (each after a short warm-up): the tokens must be equal, and the
    launches."""
    from repro_torch.launch.steps import distribute, distribute_model
    from repro_torch.models.common import BATCH, pspec, use_mesh
    arch, batch, prompt, new = MESH_SERVE
    cfg = get_config(arch)
    g = torch.Generator(device=DEV).manual_seed(0)
    model = Transformer(cfg, DEV, generator=g)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=DEV)
    runs = {}
    for name in ("plain", "mesh"):
        if name == "mesh":
            distribute_model(model, mesh)
            with use_mesh(mesh):
                prompts = distribute(prompts, mesh, pspec(BATCH, None))
        generate(model, prompts[:, :16], 2)          # warm-up, not counted
        reset_counts()
        out = generate(model, prompts, new)
        launches = read_counts()
        runs[name] = {
            "tokens": out.tokens.full_tensor() if name == "mesh"
            else out.tokens,
            "logits": out.logits.full_tensor() if name == "mesh"
            else out.logits,
            "prefill_ms": out.prefill_s * 1e3,
            "decode_ms_per_step": out.decode_s * 1e3 / (new - 1),
            "launches": launches,
            "flash_impls": dict(flash_attention.impl_launches)}
    plain, shard = runs["plain"], runs["mesh"]
    res = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
           "prompt": prompt, "tokens": new, "mesh": [1, 1],
           "tokens_equal": bool(torch.equal(plain["tokens"],
                                            shard["tokens"])),
           "logits_max_abs_diff": (plain["logits"]
                                   - shard["logits"]).abs().max().item(),
           **{f"{k}_{n}": runs[n][k] for n in runs for k in (
               "prefill_ms", "decode_ms_per_step")},
           "launches": shard["launches"], "plain_launches": plain["launches"],
           "flash_impls": shard["flash_impls"]}
    res["decode_ms_over_plain"] = res["decode_ms_per_step_mesh"] / \
        res["decode_ms_per_step_plain"]
    log(f"[mesh] serve {json.dumps(res)}")
    del model, runs, plain, shard
    torch.cuda.empty_cache()
    if not res["tokens_equal"] or res["launches"] != res["plain_launches"]:
        raise AssertionError(f"mesh serve: tokens equal "
                             f"{res['tokens_equal']}, launches "
                             f"{res['launches']} vs {res['plain_launches']}")
    return res


def phase_mesh(train_runs: dict) -> dict:
    """Phase 10: the dry run's cells started in the background, then
    ``mesh_train`` against phase 9's MESH_TRAIN run and ``mesh_serve`` on
    a (1, 1) mesh of the card over NCCL (``make_local_mesh``, a process
    group of one rank), then the dry runs' results.  Returns the two runs
    (their launches join the kernels line's) and the dry runs under
    ``dryrun``."""
    from repro_torch.launch.mesh import make_local_mesh
    procs = start_dryruns()
    try:
        mesh = make_local_mesh(1, 1)
        arch, layers = MESH_TRAIN[:2]
        plain = next(r for r in train_runs.values()
                     if r["arch"] == arch and r["layers"] == layers
                     and r["remat"] == "none")
        runs = {"mesh train": mesh_train(mesh, plain),
                "mesh serve": mesh_serve(mesh)}
        plain.pop("first_grads", None)
    finally:
        dry = finish_dryruns(procs)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return runs, dry


def kernel_line(rows: dict, runs: dict) -> dict:
    """One entry per kernel; its top-level numbers are those of its first
    timed case (a serve shape in bf16, the scans in fp32 as the models run
    them, the group labels at mobilenet_v3 and density 0.5), the other cases
    are listed under ``cases``; ``launches`` is the sum over the main-path
    runs (serve, phase 5's full-width fp32 runs, search, phase 7's
    island runs and phase 8's in-process daemon and spacemap/``file:``
    runs) counted in this process, each run's under ``launches_by_run``;
    the group labels launched by phases 7 and 8's spawned island processes
    are under ``launches_in_island_processes`` (phase 8's restarted
    daemon runs in its own process and is not counted).  Flash attention has one entry per kernel
    that ran (each case's ``impl``, each run's ``flash_impls``); its
    backward's entry is the plan's kernel at qwen2-7b's shape (``tc``), with
    both kernels under ``impls`` (each case's ``impl``, each run's
    ``bwd_impls``; ``simt`` timed forced at qwen2-7b's shape; both at
    recurrentgemma-2b's window under ``cases``, ``tc`` planned)."""
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
        "flash_attention_bwd": (
            "src/repro_torch/csrc/flash_bwd_tc.cu",
            "backward of " + flash + ": no TPU counterpart, the reference "
            "differentiates its plain attention "
            "(src/repro/models/attention.py:149-176) through XLA"),
        "rmsnorm_bwd": (
            "src/repro_torch/csrc/rmsnorm.cu (rmsnorm_bwd)",
            "backward of src/repro/kernels/rmsnorm/kernel.py:34 "
            "(rmsnorm_kernel): no TPU counterpart, the reference "
            "differentiates its plain rmsnorm "
            "(src/repro/models/common.py:177-181) through XLA"),
        "rglru_gated_bwd": (
            "src/repro_torch/csrc/rglru_scan.cu (rglru_gated_bwd)",
            "backward of src/repro/kernels/rglru_scan/kernel.py:39 "
            "(rglru_scan_kernel) with the gate arithmetic: no TPU "
            "counterpart, the reference differentiates rglru_mix "
            "(src/repro/models/rglru.py:65) and linear_scan_chunked "
            "(src/repro/models/scan_ops.py:32) through XLA"),
        "mamba_scan_bwd": (
            "src/repro_torch/csrc/mamba_scan.cu (mamba_scan_bwd)",
            "backward of src/repro/kernels/mamba_scan/kernel.py:48 "
            "(mamba_scan_kernel): no TPU counterpart, the reference "
            "differentiates mamba_mix (src/repro/models/mamba.py:72) and "
            "linear_scan_chunked (src/repro/models/scan_ops.py:32) "
            "through XLA"),
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
        source, replaces = meta.get(name) or \
            meta[name.removeprefix("flash_attention_")]
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
        if name == "flash_attention_bwd":
            out[-1]["impls"] = {impl: bwd_impl_entry(impl, cases, runs)
                                for impl in flash_attention_bwd.impl_launches}
    return {"kernels": out}


def bwd_impl_entry(impl: str, cases: list, runs: dict) -> dict:
    """One backward kernel's numbers for the kernels line: its first timed
    case, its launches over the runs."""
    mine = [c for c in cases if c["impl"] == impl]
    main = next(c for c in mine if "ms" in c)
    return {"route": "cuda", "source": {
                "tc": "src/repro_torch/csrc/flash_bwd_tc.cu",
                "simt": "src/repro_torch/csrc/flash_attention_bwd.cu"}[impl],
            "launches": sum(res.get("bwd_impls", {}).get(impl, 0)
                            for res in runs.values()),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "forced")}}


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
    ap.add_argument("--train-only", action="store_true",
                    help="build, then only phase 9, training (no contract "
                         "line)")
    ap.add_argument("--train-probe", action="store_true",
                    help="build, then only the peak memory of the training "
                         "runs' configs at a few depths (no contract line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, then only phase 9's first run and phase "
                         "10, the mesh path (no contract line)")
    ap.add_argument("--rglru-ablate", action="store_true",
                    help="build, then only the gated RG-LRU backward "
                         "kernel's ablations (no contract line)")
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
    if args.train_probe:
        train_probe()
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.rglru_ablate:
        rglru_ablate()
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.train_only:
        phase_train()
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.mesh_only:
        arch, layers, batch, seq, lr, steps = MESH_TRAIN
        phase_mesh({"plain": train_run(arch, layers, batch, seq, lr, steps,
                                       keep_grads=True)})
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    timer = Timer()
    rows = phase_kernels(timer)
    log(f"[time] kernels done at {time.perf_counter() - t0:.1f} s")
    phase_moe(timer)
    del timer
    log(f"[time] moe dispatch done at {time.perf_counter() - t0:.1f} s")
    runs = phase_serve()
    log(f"[time] serve done at {time.perf_counter() - t0:.1f} s")
    runs.update(phase_fp32())
    log(f"[time] fp32 done at {time.perf_counter() - t0:.1f} s")
    runs.update(phase_search())
    log(f"[time] search done at {time.perf_counter() - t0:.1f} s")
    runs.update(phase_service())
    log(f"[time] service done at {time.perf_counter() - t0:.1f} s")
    runs.update(phase_daemon())
    log(f"[time] daemon done at {time.perf_counter() - t0:.1f} s")
    train_rows, train_runs = phase_train()
    rows.update(train_rows)
    runs.update(train_runs)
    log(f"[time] train done at {time.perf_counter() - t0:.1f} s")
    mesh_runs, _ = phase_mesh(train_runs)
    runs.update(mesh_runs)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernel_line(rows, runs)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
