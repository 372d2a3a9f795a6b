"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

Counterpart: ``repro/launch/dryrun.py``.  For each cell this builds the
production mesh (16x16 single pod, 2x16x16 multi-pod, or the (2, 4) local
mesh) on a fake process group, makes the model's parameters, the optimizer
state, the batch and the caches as fake tensors (``FakeTensorMode``: no
allocation) distributed by the port's specs, runs the port's own train,
prefill or decode step on them once as the mesh's last rank (the
busiest: under a sequence split its queries see the longest causal
prefix), and records into
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``:

* ``memory``: ``argument_size_bytes``, the local shards of the step's
  arguments (exact: the specs' shard shapes); ``temp_size_bytes``, the
  peak of the step's own live tensors (``temp_at_peak_by_op``: those
  bytes by the op that made them); ``output_size_bytes``, those still
  live after it; ``peak_bytes``, arguments plus temp;
* ``cost``: ``flops``, ``bytes accessed`` and ``transcendentals`` of one
  device, the aten ops' (``torch.utils.flop_counter``'s formulas; each op's
  tensor inputs and outputs, views left out) plus each kernel call's (the
  formulas behind ``PERF.md``'s bounds, ``kernels/_fake.py``);
* ``collectives``: the result-shape bytes of each collective DTensor
  runs, under the reference's kinds (``repro/roofline/analysis.py``).

The kernels take the card's route whatever the device (``_fake``): the
plain versions' Python loops are never traced, and the CPU and the card
trace one program.  A step that the card's kernels refuse
(``KernelRefusal``: the flash backward takes no query offset, which
``fsdp`` training gives every rank but the first) is reported
``refused``, with the kernel's reason and the argument bytes, and no
cost.  The MoE runs at the reference's capacity shapes (its mesh path:
slot buffers).  The counts are the port's own reckoning of its
eager program, not XLA's of the reference's compiled one; the artifact says
which are exact (``counts``).  Eager tracing runs every layer, so
``--cost-mode scanned`` is exact at full depth; ``extrapolate`` keeps the
reference's two-point rule (``_depth_points``, ``_combine_costs``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time
import traceback
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (SHAPES, cell_skip_reason, get_config,
                                 get_reduced, iter_cells)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import _fake
from repro_torch.kernels._grad import KernelRefusal
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.models.common import (BATCH, pspec, set_sharding_mode,
                                       use_mesh)
from repro_torch.models.transformer import Transformer, cache_specs
from repro_torch.optim import AdamWConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
_COST_KEYS = ("flops", "bytes accessed", "transcendentals")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_KIND_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("broadcast", "collective-permute"),
            ("permute", "collective-permute"))
_TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "sin", "cos", "rsqrt",
                   "sqrt", "softplus", "gelu", "silu", "erf", "pow")
COUNTS = {
    "exact": ["memory.argument_size_bytes"],
    "port_reckoning": ["memory.temp_size_bytes", "memory.output_size_bytes",
                       "cost", "collectives"],
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_bytes(tensors) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tensors if isinstance(t, torch.Tensor))


def _in_sharding_prop() -> bool:
    """Whether DTensor's own bookkeeping runs the op: its sharding
    propagation (on global shapes, to learn the output's metadata) or a
    placement's index arithmetic.  No device does that work."""
    f = sys._getframe(2)
    while f is not None:
        if "_sharding_prop" in f.f_code.co_filename or \
                f.f_code.co_name in _SHARD_MATH:
            return True
        f = f.f_back
    return False


_SHARD_MATH = ("local_shard_size_and_offset", "_local_shard_size_and_offset")


@contextlib.contextmanager
def _placement_math_on_host():
    """DTensor's ``_StridedShard`` (a dim merged from two split dims, as
    (batch, sequence) in ``fsdp`` mode) computes its shard sizes with
    tensors and reads them back (``tolist``), which fake tensors cannot:
    run that arithmetic with real (host) tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    names = [n for n in _SHARD_MATH if cls is not None and n in vars(cls)]
    saved = {n: vars(cls)[n] for n in names}

    def host(fn):
        raw = fn.__func__ if isinstance(fn, (staticmethod, classmethod)) \
            else fn

        @functools.wraps(raw)
        def run(*a, **k):
            with unset_fake_temporarily():
                return raw(*a, **k)
        return type(fn)(run) if isinstance(
            fn, (staticmethod, classmethod)) else run
    try:
        for n, fn in saved.items():
            setattr(cls, n, host(fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


class CostCounter(TorchDispatchMode):
    """Counts the local (per-device) aten ops of a trace: flops, bytes,
    transcendentals, collectives by kind, and the live bytes of the
    tensors they make (peak and end).  DTensor ops pass through
    (``NotImplemented``): their local ops come back here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.cost = dict.fromkeys(_COST_KEYS, 0)
        self.collectives: Dict[str, int] = dict.fromkeys(_COLLECTIVES, 0)
        self.collectives["count"] = 0
        self.live = self.peak = 0
        self._refs: Dict[int, list] = {}
        self._by_op: Dict[str, int] = {}
        self.peak_by_op: Dict[str, int] = {}

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            self._by_op[ref[2]] -= ref[0]
            del self._refs[key]

    def _track(self, t: torch.Tensor, op: str) -> None:
        """Count t's storage live until its last tensor dies, under the op
        that made it."""
        key = t.untyped_storage()._cdata
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [t.untyped_storage().nbytes(), 0, op]
            self.live += ref[0]
            self._by_op[op] = self._by_op.get(op, 0) + ref[0]
            if self.live > self.peak:
                self.peak = self.live
                self.peak_by_op = dict(self._by_op)
        ref[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_prop():
            return out
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        name = func._overloadpacket.__name__
        for o in outs:
            self._track(o, name)
        ins = [a for a in list(args) + list(kwargs.values())
               if isinstance(a, torch.Tensor)]
        for a in args:
            if isinstance(a, (list, tuple)):
                ins += [x for x in a if isinstance(x, torch.Tensor)]
        kind = next((k for s, k in _KIND_OF if s in name), None)
        if func.namespace.startswith("_c10d_functional") and kind:
            self.collectives[kind] += sum(_nbytes(o) for o in outs)
            self.collectives["count"] += 1
            return out
        if not ins or getattr(func, "is_view", False) or name in (
                "wait_tensor", "device", "detach", "alias"):
            return out
        flop = self.registry.get(func._overloadpacket)
        if flop is not None:
            self.cost["flops"] += int(flop(*args, **kwargs, out_val=out))
        self.cost["bytes accessed"] += sum(_nbytes(t) for t in ins + outs)
        if any(s in name for s in _TRANSCENDENTAL):
            self.cost["transcendentals"] += sum(o.numel() for o in outs)
        return out


def _batch(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The step's inputs (the reference's ``input_specs``), random."""
    B, S = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16
    if shape.kind == "decode":
        return {"token": torch.randint(0, cfg.vocab, (B, 1),
                                       dtype=torch.int32)}
    text = S - cfg.img_tokens
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, text),
                                     dtype=torch.int32)}
    if shape.kind == "train":
        batch["labels"] = torch.randint(0, cfg.vocab, (B, text),
                                        dtype=torch.int32)
    if cfg.img_tokens:
        batch["img_embeds"] = torch.randn(B, cfg.img_tokens, cfg.d_model,
                                          dtype=bf16)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(B, cfg.enc_seq, cfg.d_model,
                                      dtype=bf16)
    return batch


def _trace(cfg: ModelConfig, shape: ShapeConfig, mesh, microbatches: int,
           grad_compression: bool) -> dict:
    """One step of the cell under fake tensors on ``mesh``, counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with use_mesh(mesh), _placement_math_on_host(), \
            FakeTensorMode(allow_non_fake_inputs=True), \
            _fake.tracing() as kernels:
        train = shape.kind == "train"
        model = steps_lib.distribute_model(
            Transformer(cfg, "cpu", trainable=train), mesh)
        args = list(model.parameters())
        batch = _batch(cfg, shape)
        if shape.kind == "train":
            step, opt_init = steps_lib.make_train_step(
                model, AdamWConfig(moment_dtype=cfg.moment_dtype),
                microbatches=microbatches, grad_compression=grad_compression)
            opt = opt_init()
            batch = steps_lib.distribute_batch(
                batch, steps_lib.train_batch_pspecs(cfg), mesh)
            args += [*opt["adam"]["mu"].values(), *opt["adam"]["nu"].values(),
                     opt["adam"]["step"], *opt.get("ef", {}).values(),
                     *batch.values()]

            def run():
                step(opt, batch)
        elif shape.kind == "prefill":
            batch = steps_lib.distribute_batch(batch, {
                k: pspec(BATCH, *[None] * (v.ndim - 1))
                for k, v in batch.items()}, mesh)
            args += list(batch.values())
            step = steps_lib.make_prefill_step(model, shape.seq_len)

            def run():
                with torch.no_grad():
                    step(batch)
        else:
            B, S = shape.global_batch, shape.seq_len
            cache = model.init_cache(B, S)
            if cfg.is_encdec:        # the cross K/V a prefill would keep
                specs = cache_specs(cfg, shard_seq=B == 1)
                kv = (B, cfg.enc_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
                for c, sp in zip(cache.layers, specs):
                    for n in ("cross_k", "cross_v"):
                        c[n] = steps_lib.distribute(
                            torch.zeros(kv, dtype=model.dtype), mesh, sp[n])
            cache.length = S - 1
            specs = steps_lib.decode_input_pspecs(cfg, shape)
            batch = steps_lib.distribute_batch(batch, specs, mesh)
            batch.update(pos=S - 1, caches=cache)
            args += [batch["token"], torch.zeros((), dtype=torch.int32)]
            args += [t for c in cache.layers for t in c.values()]
            step = steps_lib.make_decode_step(model)

            def run():
                with torch.no_grad():
                    step(batch)
        arg_bytes = _local_bytes(args)
        counter = CostCounter()
        try:
            with counter:
                run()
        except KernelRefusal as e:
            return {"refused": str(e), "trace_s": time.time() - t0,
                    "memory": {"argument_size_bytes": arg_bytes}}
        del run, step, batch, model, args
        out = {"memory": {"argument_size_bytes": arg_bytes,
                          "temp_size_bytes": counter.peak,
                          "output_size_bytes": counter.live,
                          "peak_bytes": arg_bytes + counter.peak,
                          "generated_code_size_bytes": None,
                          # the live temp bytes at the peak by the op that
                          # made them, the largest first
                          "temp_at_peak_by_op": dict(sorted(
                              ((k, v) for k, v in counter.peak_by_op.items()
                               if v), key=lambda kv: -kv[1])[:12])}}
        cost = dict(counter.cost)
        for w in kernels.values():
            cost["flops"] += w["flops"]
            cost["bytes accessed"] += w["bytes"]
        out["cost"] = cost
        out["collectives"] = dict(counter.collectives)
        out["kernels"] = {k: dict(v) for k, v in kernels.items()}
    out["trace_s"] = time.time() - t0
    return out


def _depth_points(cfg: ModelConfig):
    """Two shallow configs whose cost delta is one repeat unit of the layer
    stack (the reference's rule)."""
    plen = (len(cfg.block_pattern) or
            (cfg.global_every if cfg.attn_chunk and cfg.global_every else 1))
    reps_full = cfg.n_layers // plen
    rem = cfg.n_layers % plen
    if reps_full < 2:
        return None
    mk = lambda r: dataclasses.replace(
        cfg, n_layers=plen * r + rem, scan_layers=False, exact_costs=True,
        n_enc_layers=(r if cfg.is_encdec else cfg.n_enc_layers))
    return mk(1), mk(2), reps_full


def _combine_costs(a: dict, b: dict, reps_full: int) -> dict:
    """total = a + (b - a) * (reps_full - 1), per cost key and collective,
    clamped at the single-repeat value (the reference's rule)."""
    out = {"cost": {}, "collectives": {}}
    for k in _COST_KEYS:
        ca, cb = a["cost"].get(k, 0), b["cost"].get(k, 0)
        out["cost"][k] = max(ca + (cb - ca) * (reps_full - 1), ca)
    for k in set(a["collectives"]) | set(b["collectives"]):
        ca, cb = a["collectives"].get(k, 0), b["collectives"].get(k, 0)
        out["collectives"][k] = int(max(ca + (cb - ca) * (reps_full - 1),
                                        ca))
    return out


def _mesh(kind: str):
    if kind == "local":
        return make_fake_mesh((2, 4), ("data", "model"))
    return make_production_mesh(multi_pod=kind == "multi")


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             attn_impl: str = "auto", remat: str = "none",
             cost_mode: str = "extrapolate", microbatches: int = 1,
             reduced: bool = False, grad_compression: bool = False,
             sharding: str = "tp") -> dict:
    set_sharding_mode(sharding)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if remat != "none":
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name]
    if reduced:   # integration-test scale: tiny shape, 8-rank local mesh
        shape = dataclasses.replace(shape, seq_len=64, global_batch=4)
    mesh = _mesh(mesh_kind)
    art = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": int(mesh.size()), "attn_impl": attn_impl,
           "remat": remat, "microbatches": microbatches,
           "grad_compression": grad_compression, "sharding": sharding,
           "status": "ok", "counts": COUNTS}
    full = _trace(cfg, shape, mesh, microbatches, grad_compression)
    art["trace_s"] = round(full["trace_s"], 2)
    art["memory"] = full["memory"]
    art["n_params"] = int(cfg.n_params)
    art["n_active_params"] = int(cfg.n_active_params)
    art["tokens"] = int(shape.global_batch *
                        (shape.seq_len if shape.kind != "decode" else 1))
    if "refused" in full:
        art.update(status="refused", reason=full["refused"], cost=None,
                   collectives=None)
        return art
    art["kernels"] = full["kernels"]
    art["cost_scanned"] = full["cost"]
    art["collectives_scanned"] = full["collectives"]
    if cost_mode == "extrapolate" and (pts := _depth_points(cfg)):
        cfg_a, cfg_b, reps_full = pts
        ca = _trace(cfg_a, shape, mesh, 1, grad_compression)
        cb = _trace(cfg_b, shape, mesh, 1, grad_compression)
        ext = _combine_costs(ca, cb, reps_full)
        art["cost"] = ext["cost"]
        art["collectives"] = ext["collectives"]
        art["cost_points"] = {"a": ca["cost"], "b": cb["cost"],
                              "reps_full": reps_full,
                              "layers_a": cfg_a.n_layers,
                              "layers_b": cfg_b.n_layers}
    else:
        art["cost"] = full["cost"]
        art["collectives"] = full["collectives"]
    return art


def save_artifact(art: dict, out_dir: str, extra_tag: str = "") -> str:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{extra_tag}" if extra_tag else ""
    path = os.path.join(
        out_dir, f"{art['arch']}__{art['shape']}__{art['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "local"])
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + tiny shape (integration tests)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attn-impl", default="auto",
                    help="recorded only: the kernels' plans choose")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--cost-mode", default="extrapolate",
                    choices=["extrapolate", "scanned"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--sharding", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch, sname, _, skip in iter_cells():
            cells.extend((arch, sname, m, skip) for m in meshes)
    else:
        skip = cell_skip_reason(args.arch, args.shape)
        cells.extend((args.arch, args.shape, m, skip) for m in meshes)

    failures = 0
    for arch, sname, m, skip in cells:
        label = f"{arch} x {sname} x {m}"
        if skip:
            art = {"arch": arch, "shape": sname, "mesh": m,
                   "status": "skipped", "reason": skip,
                   "chips": 512 if m == "multi" else 256}
            save_artifact(art, args.out, args.tag)
            print(f"[SKIP] {label}: {skip}", flush=True)
            continue
        try:
            art = run_cell(arch, sname, m, attn_impl=args.attn_impl,
                           remat=args.remat, cost_mode=args.cost_mode,
                           microbatches=args.microbatches,
                           reduced=args.reduced,
                           grad_compression=args.grad_compression,
                           sharding=args.sharding)
            path = save_artifact(art, args.out, args.tag)
            if art["status"] == "refused":
                print(f"[REFUSED] {label}: {art['reason']}", flush=True)
                continue
            coll = art["collectives"]
            print(f"[OK]   {label}: trace={art['trace_s']}s "
                  f"flops={art['cost']['flops']:.3e} "
                  f"mem={art['memory']['peak_bytes'] / 1e9:.2f}GB "
                  f"coll={sum(v for k, v in coll.items() if k != 'count'):.3e}B "
                  f"-> {os.path.basename(path)}", flush=True)
        except Exception as e:
            failures += 1
            art = {"arch": arch, "shape": sname, "mesh": m,
                   "status": "failed", "error": traceback.format_exc()}
            save_artifact(art, args.out, args.tag)
            print(f"[FAIL] {label}: {e!r}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
