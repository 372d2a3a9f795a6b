#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and the script exits
non-zero (no phase's failure is caught):

1. device: the card's name and power limit;
2. build: every ``src/repro_torch/csrc/*.cu`` compiled with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the serve path's shapes and at small ragged/masked ones, and timed
   beside its bound and one library call (a yardstick the port never calls);
4. serve: chatglm3-6b at its published widths and 28 layers in bf16, random
   weights from a seeded CUDA generator, 8 prompts of 1024 tokens and 32
   greedy tokens through ``repro_torch.launch.serve.generate``; the launch
   counts of that run are checked exactly and the decode logits are held
   against one full forward;
5. the same check in fp32 at full width with 2 layers, and the reduced
   config's CUDA logits against its plain CPU path (which the CPU tests hold
   against the JAX reference).

Before the last line: one JSON line ``{"kernels": [...]}`` and the
``nvidia-smi`` name/power-limit line.  Last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

# tests/test_kernels.py:15 of the reference
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# H100 SXM data sheet (dense): bytes/s of HBM3, flop/s by input type
# (bf16 on the tensor cores, fp32 outside them: TF32 is switched off here)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# serve shape of phase 4 (and the kernels' main-path shapes)
ARCH, BATCH, PROMPT, NEW = "chatglm3-6b", 8, 1024, 32
# decode logits vs one full forward, relative RMS error over all logits.
# bf16: both sides round every product to 8 mantissa bits (2^-9 = 2e-3
# relative per rounding) but at different places (cuBLAS picks other kernels
# for 8 rows than for 8440), and the differences add up over 28 layers; a
# wrong cache slot, position or mask gives errors of order 1.
SERVE_REL_TOL_BF16 = 5e-2
# fp32 (TF32 off): sums in another order only (~1e-6); bf16 arithmetic or
# TF32 would give >= 1e-3 and fail it.
SERVE_REL_TOL_FP32 = 1e-4


def log(*a) -> None:
    print(*a, flush=True)


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
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
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


def rmsnorm_bound_ms(n: int, d: int, dt: torch.dtype) -> float:
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = 2 * n * d * es + d * es        # x read, y written, w read
    flops = 4 * n * d                       # square, sum, scale, weight
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.float32]) * 1e3


def flash_work(B, Sq, Skv, Hq, Hkv, D, dt, causal=True, window=0, chunk=0,
               q_offset=0, kv_len=None):
    """(bytes, flops) this call needs: q, o and the keys any query can see,
    once each; 4*D flops per unmasked (query, key) pair."""
    kv_len = Skv if kv_len is None else kv_len
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    ok = (kp < kv_len) & (qp >= 0)              # (Sq, Skv)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    if chunk:
        ok &= kp // chunk == qp // chunk
    keys_needed = int(ok.any(0).sum())
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = (2 * B * Sq * Hq * D + 2 * B * keys_needed * Hkv * D) * es
    return nbytes, 4 * D * B * Hq * int(ok.sum())


def flash_bound_ms(nbytes: int, flops: int, dt) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


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


def phase_kernels(timer: Timer) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rn(*shape, dt):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    d = get_config(ARCH).d_model
    rows = {}
    # ---- RMSNorm: both forms, both dtypes; serve shapes + a ragged one
    rms_cases = []
    for dt in (torch.float32, torch.bfloat16):
        for n, dd in ((BATCH * PROMPT, d), (BATCH, d), (37, 130)):
            x, r = rn(n, dd, dt=dt), rn(n, dd, dt=dt)
            w = (rn(dd, dt=torch.float32) * 0.1 + 1.0).to(dt)
            err = close(fused_rmsnorm(x, w), rmsnorm_ref(x, w), TOL[dt])
            y, res = fused_rmsnorm(x, w, r)
            yr, resr = rmsnorm_ref(x, w, r)
            err_r = max(close(y, yr, TOL[dt]), close(res, resr, TOL[dt]))
            case = {"shape": [n, dd], "dtype": str(dt)[6:], "tol": TOL[dt],
                    "max_abs_err": err, "residual_max_abs_err": err_r}
            if dt == torch.bfloat16 and dd == d:       # the serve path's
                case.update(
                    ms=timer.ms(lambda: fused_rmsnorm(x, w)),
                    plain_ms=timer.ms(lambda: rmsnorm_ref(x, w)),
                    library_ms=timer.ms(
                        lambda: F.rms_norm(x, (dd,), w, eps=1e-6)),
                    bound_ms=rmsnorm_bound_ms(n, dd, dt), bound_by="bytes")
            log(f"[kernels] rmsnorm {case}")
            rms_cases.append(case)
    rows["rmsnorm"] = rms_cases

    # ---- flash attention: serve prefill/decode + small ragged/masked
    cfg = get_config(ARCH)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    buf = PROMPT + NEW
    pos = PROMPT + 16
    shapes = [
        ("prefill", (BATCH, PROMPT, PROMPT, hq, hkv, hd), {}),
        ("decode", (BATCH, 1, buf, hq, hkv, hd),
         dict(q_offset=pos, kv_len=pos + 1)),
        ("decode_whole_buffer", (BATCH, 1, buf, hq, hkv, hd),
         dict(q_offset=pos)),
        ("mqa_ragged", (1, 33, 33, 8, 1, 16), {}),
        ("gqa_ragged", (2, 80, 80, 4, 2, 32), {}),
        ("window", (2, 96, 96, 4, 2, 32), dict(window=16)),
        ("chunk", (2, 96, 96, 4, 2, 32), dict(chunk=32)),
        ("bidir", (2, 96, 96, 4, 2, 32), dict(causal=False)),
        ("decode_d32", (2, 1, 64, 4, 2, 32), dict(q_offset=40, kv_len=41)),
    ]
    fa_cases = []
    for dt in (torch.float32, torch.bfloat16):
        for name, (B, Sq, Skv, Hq, Hkv, D), kw in shapes:
            q, k, v = rn(B, Sq, Hq, D, dt=dt), rn(B, Skv, Hkv, D, dt=dt), \
                rn(B, Skv, Hkv, D, dt=dt)
            err = close(flash_attention(q, k, v, **kw),
                        attention_ref(q, k, v, **kw), TOL[dt])
            case = {"case": name, "shape": [B, Sq, Skv, Hq, Hkv, D], **kw,
                    "dtype": str(dt)[6:], "tol": TOL[dt], "max_abs_err": err}
            if dt == torch.bfloat16 and name in ("prefill", "decode"):
                n_kv = kw.get("kv_len", Skv)
                qt, kt, vt = (t.transpose(1, 2) for t in
                              (q, k[:, :n_kv], v[:, :n_kv]))
                case.update(
                    ms=timer.ms(lambda: flash_attention(q, k, v, **kw)),
                    plain_ms=timer.ms(lambda: attention_ref(q, k, v, **kw),
                                      reps=5),
                    library_ms=timer.ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=name == "prefill",
                            enable_gqa=True)))
                nbytes, flops = flash_work(B, Sq, Skv, Hq, Hkv, D, dt, **kw)
                case["bytes"], case["flops"] = nbytes, flops
                case["bound_ms"], case["bound_by"] = flash_bound_ms(
                    nbytes, flops, dt)
            log(f"[kernels] flash_attention {case}")
            fa_cases.append(case)
    rows["flash_attention"] = fa_cases
    return rows


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def serve_check(cfg, batch, prompt, new, tol, label, warm=False):
    """generate() then one forward over prompt + generated tokens; the
    decode logits must match the forward's at the same positions."""
    g = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer(cfg, "cuda", generator=g)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device="cuda")
    if warm:                      # cuBLAS handles, allocator: not timed
        generate(model, prompts[:, :16], 2)
    torch.cuda.reset_peak_memory_stats()
    fused_rmsnorm.launches = flash_attention.launches = 0
    out = generate(model, prompts, new)
    launches = {"rmsnorm": fused_rmsnorm.launches,
                "flash_attention": flash_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if out.tokens.shape != (batch, new) or out.logits.shape != (
            batch, new, cfg.vocab) or not torch.isfinite(out.logits).all():
        raise AssertionError(f"{label}: bad generate output")
    full = torch.cat([prompts, out.tokens[:, :-1]], 1)
    ref = model(full)[:, prompt - 1:]
    err = rel_rms(out.logits, ref)
    agree = (out.logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    res = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": batch, "prompt": prompt, "tokens": new,
           "prefill_ms": out.prefill_s * 1e3,
           "decode_ms_per_step": out.decode_s * 1e3 / max(new - 1, 1),
           "decode_tok_per_s": batch * (new - 1) / out.decode_s,
           "peak_mem_gb": peak_gb, "launches": launches,
           "logits_rel_rms_vs_forward": err, "tol": tol,
           "logits_max_abs_diff": (out.logits - ref).abs().max().item(),
           "argmax_agreement": agree}
    log(f"[serve] {label} {json.dumps(res)}")
    if not err <= tol:
        raise AssertionError(f"{label}: decode logits vs forward relative "
                             f"RMS error {err:.3e} > {tol:g}")
    del model
    torch.cuda.empty_cache()
    return res


def phase_serve() -> dict:
    cfg = get_config(ARCH)
    res = serve_check(cfg, BATCH, PROMPT, NEW, SERVE_REL_TOL_BF16,
                      "bf16 full", warm=True)
    per_forward = {"rmsnorm": 2 * cfg.n_layers + 1,
                   "flash_attention": cfg.n_layers}
    expect = {k: v * NEW for k, v in per_forward.items()}   # 1 prefill + 31
    if res["launches"] != expect:
        raise AssertionError(f"launches {res['launches']} != {expect}")
    return res


def phase_fp32() -> None:
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2,
                              param_dtype="float32")
    serve_check(cfg, BATCH, 128, 8, SERVE_REL_TOL_FP32, "fp32 2-layer")
    # the reduced config: CUDA kernels vs the plain CPU path, same weights
    small = dataclasses.replace(get_reduced(ARCH), param_dtype="float32")
    gpu = Transformer(small, "cuda", seed=3)
    cpu = Transformer(small, "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    toks = torch.randint(0, small.vocab, (2, 37),
                         generator=torch.Generator().manual_seed(4))
    err = close(gpu(toks.cuda()).cpu(), cpu(toks), 1e-4)
    log(f"[serve] reduced {small.name} cuda vs cpu plain path: max abs err "
        f"{err:.3e} (tol 1e-4 abs + rel: fp32, sums in another order)")


def kernel_line(rows: dict, launches: dict) -> dict:
    """One entry per kernel; the numbers are those of the serve prefill
    shape in bf16, the other cases are listed under ``cases``."""
    meta = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:34 (rmsnorm_kernel)"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:78 "
            "(flash_attention_kernel)"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        main = next(c for c in rows[name] if "ms" in c)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": main["max_abs_err"], "max_err": main["max_abs_err"],
            "ms": main["ms"], "kernel_ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "cases": rows[name]})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels(Timer())
    res = phase_serve()
    phase_fp32()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernel_line(rows, res["launches"])))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
