"""Analytical TPU cost model for schedule candidates (the GA's Timeloop).

The paper costs fusion states with Timeloop/Accelergy; on TPU the equivalent
"mapping evaluation" estimates, per training step and per chip:

* FLOPs  — 6 * active_params * tokens (+ attention) with remat recompute;
* HBM    — parameter + optimizer traffic, activation save/restore traffic
           under the chosen remat policy (the analogue of the paper's
           on-chip vs DRAM activation residency);
* ICI    — TP all-reduces per layer + the data-parallel gradient reduce
           (optionally int8-compressed);
* HBM residency — params + optimizer + live activations; candidates that
  exceed capacity are invalid, exactly like the paper's activation-buffer
  capacity check.

Absolute numbers are estimates of the modelled TPU target (its
parameters are the reference's ``HW`` and energy constants, copied so the
port's results equal the reference's), not of the card the port runs on.

The port's copy of ``repro/costmodel/tpu_model.py``: plain float
expressions in the reference's order, so every result is equal, not close.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.roofline.analysis import HW

# activation words saved per token per layer, in units of d_model, by remat
# policy (transformer block: ~2 norms, qkvo, 2-3 mlp intermediates, attn)
_ACT_SAVE_FACTOR = {"none": 14.0, "selective": 6.0, "full": 1.0}
# extra forward recompute in the backward pass, fraction of fwd FLOPs
_RECOMPUTE = {"none": 0.0, "selective": 0.35, "full": 1.0}

# the full genome option sets — single source of truth for mutate_options
# AND the search problem's enumerate/space_size/random sampling
# (repro_torch.search.tpu); extending one extends both
REMAT_OPTIONS = tuple(_RECOMPUTE)
MICROBATCH_OPTIONS = (1, 2, 4, 8, 16)
SHARDING_OPTIONS = ("tp", "fsdp")     # tp (Megatron) | fsdp (ZeRO-3 + SP)


@dataclass(frozen=True)
class TpuSchedule:
    """Genome for the TPU scheduling GA."""
    remat: str = "none"               # per-run policy (none|selective|full)
    microbatches: int = 1
    grad_compression: bool = False
    sharding: str = "tp"

    def mutate_options(self):
        return (
            [TpuSchedule(r, self.microbatches, self.grad_compression,
                         self.sharding)
             for r in REMAT_OPTIONS if r != self.remat]
            + [TpuSchedule(self.remat, m, self.grad_compression,
                           self.sharding)
               for m in MICROBATCH_OPTIONS if m != self.microbatches]
            + [TpuSchedule(self.remat, self.microbatches,
                           not self.grad_compression, self.sharding)]
            + [TpuSchedule(self.remat, self.microbatches,
                           self.grad_compression, s)
               for s in SHARDING_OPTIONS if s != self.sharding]
        )


@dataclass(frozen=True)
class TpuCost:
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_resident_bytes: float
    energy_j: float

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def edp(self) -> float:
        return self.energy_j * self.step_s

    @property
    def dominant(self) -> str:
        t = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
        return max(t, key=t.get)


# J per unit of the modelled TPU target (the reference's system-level
# estimates: per bf16 FLOP, per HBM byte, per chip-to-chip byte).  Public
# names: the fusion-side TPU cost model (repro_torch.costmodel.tpu_fusion)
# prices CNN schedules with the same constants.
E_FLOP_J = 0.3e-12
E_HBM_J_PER_BYTE = 10e-12
E_ICI_J_PER_BYTE = 25e-12

_E_FLOP = E_FLOP_J
_E_HBM = E_HBM_J_PER_BYTE
_E_ICI = E_ICI_J_PER_BYTE


def estimate(cfg: ModelConfig, shape: ShapeConfig, sched: TpuSchedule,
             *, chips: int = 256, data_par: int = 16, model_par: int = 16,
             hw: HW = HW()) -> TpuCost:
    """Per-chip cost of one training step under ``sched``."""
    tokens = shape.global_batch * shape.seq_len
    tokens_chip = tokens / data_par                # model axis shares tokens
    n_active = cfg.n_active_params
    bytes_per_param = 2                            # bf16

    # ---- FLOPs ------------------------------------------------------------------
    base = 6.0 * n_active * tokens / chips         # fwd+bwd matmuls
    attn_flops = 0.0
    if cfg.family not in ("ssm",):
        # causal attention ~ 6 * L * S * d per token fwd (halved by causal),
        # x3 for bwd; local/chunked layers use their window instead of S
        kinds = cfg.layer_kinds()
        hd = cfg.resolved_head_dim * cfg.n_heads
        for kind in kinds:
            eff = shape.seq_len
            if kind == "attn_local":
                eff = min(2 * cfg.attn_window, shape.seq_len)
            elif kind == "attn_chunk":
                eff = min(cfg.attn_chunk, shape.seq_len)
            elif not kind.startswith("attn"):
                continue
            attn_flops += 2.0 * tokens * eff * hd * 0.5 * 3 / chips
    flops = (base + attn_flops) * (1.0 + _RECOMPUTE[sched.remat])

    # ---- HBM bytes ---------------------------------------------------------------
    params_chip = cfg.n_params * bytes_per_param / chips
    moment_bytes = 4 if cfg.moment_dtype == "float32" else 2
    opt_chip = cfg.n_params * 2 * moment_bytes / chips
    # params read fwd+bwd per microbatch pass + optimizer read/write
    w_traffic = params_chip * 2 * sched.microbatches + \
        (params_chip + opt_chip) * 2
    act_bytes_layer = (_ACT_SAVE_FACTOR[sched.remat] * cfg.d_model *
                       bytes_per_param)
    act_traffic = 2 * act_bytes_layer * cfg.n_layers * tokens_chip / model_par
    mem_bytes = w_traffic + act_traffic

    # ---- collectives -----------------------------------------------------------------
    if sched.sharding == "fsdp":
        # ZeRO-3: per-layer param all-gathers (fwd + bwd + remat re-gather)
        # + reduce-scatter of grads + sequence-parallel partial-sum ARs.
        gathers = 2.0 + (1.0 if sched.remat != "none" else 0.0)
        params_bytes = cfg.n_params * bytes_per_param / chips
        zero3 = params_bytes * gathers + params_bytes * 2      # RS grads fp32
        tokens_dev = tokens / chips                            # SP over model
        sp_ar = (4 * tokens_dev * cfg.d_model * bytes_per_param
                 * cfg.n_layers)
        coll_bytes = zero3 * (chips - 1) / chips * 4 + sp_ar
        # gradient compression cannot intercept the in-bwd reduce-scatter
        # (EXPERIMENTS §Perf iter 6) — no discount in fsdp mode
    else:
        tp_per_layer = 4 * tokens_chip * cfg.d_model * bytes_per_param
        tp_bytes = tp_per_layer * cfg.n_layers * (model_par - 1) / model_par
        grad_bytes_unit = 1 if sched.grad_compression else 4
        dp_bytes = cfg.n_params * grad_bytes_unit / chips * 2
        coll_bytes = tp_bytes + dp_bytes

    # ---- residency (the capacity check) -------------------------------------------------
    live_acts = (act_bytes_layer * cfg.n_layers *
                 tokens_chip / model_par / sched.microbatches)
    resident = params_chip + opt_chip + live_acts + 2 * params_chip  # grads+wk

    energy = (flops * _E_FLOP + mem_bytes * _E_HBM + coll_bytes * _E_ICI) \
        * chips
    return TpuCost(
        compute_s=flops / hw.peak_flops,
        memory_s=mem_bytes / hw.hbm_bw,
        collective_s=coll_bytes / hw.ici_bw,
        hbm_resident_bytes=resident,
        energy_j=energy)
