"""Training entry point: the train loop + data pipeline + async checkpointing +
watchdog + bounded restarts.  Usable as a library (tests, chip_smoke.py)
and as a CLI:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --layers 8 --steps 4 --batch 8 --seq 1024

Counterpart: ``repro/launch/train.py`` (``TrainRunConfig``, ``train_loop``,
``main``), with the reference's CLI plus ``--layers N`` (the first N layers
of the published config, as ``launch/serve.py`` takes it) and ``--device``
(default: the CUDA card, an error without one; ``--device cpu`` runs the
plain path) and ``--mesh DATAxMODEL`` (under torchrun: a mesh of the
launched ranks).  The loop is deterministic-resumable: batch t is a pure
function of (seed, t), so restarting from step k replays nothing (see
``repro_torch/data/pipeline.py``).  The state is ``{"model", "opt",
"train_step"}``; a checkpoint holds it in the reference's tree
(``{"params", "opt": {"adam", "ef"}}``, layers stacked by
``convert.params_to_jax``), so either package restores the other's.

``train_loop(run, mesh)`` trains on a ``DeviceMesh`` (``launch/mesh.py``):
every rank builds the model from ``run.seed`` as the plain path does, then
keeps its slices of the parameters (``steps.distribute_model``) and of each
batch.  Checkpoints stay mesh-agnostic: a save gathers every leaf's full
value (all ranks take part; rank 0 writes), and a restore, on any mesh,
gives each rank its slices of the loaded leaves.  With no mesh nothing
makes a DTensor.  The
loss is read on the host on a logging step only; the watchdog synchronises
the card before it reads its clock.  Activation recompute is
``cfg.remat`` (``models/remat.py``), set on the config as the reference's
dry run sets it; neither CLI takes a flag for it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.common import full_value, local_slice, use_mesh
from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultConfig, run_with_restarts


@dataclasses.dataclass
class TrainRunConfig:
    cfg: ModelConfig
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    lr: float = 1e-3
    microbatches: int = 1
    grad_compression: bool = False
    ckpt_dir: Optional[str] = None
    save_every: int = 50
    log_every: int = 10
    device: DeviceLike = None       # None: the CUDA card


def _full(tree: Dict) -> Dict:
    """Each tensor of a flat dict at its full value.  A DTensor's is
    gathered (a collective: every rank calls it) and moved to the host
    before the next leaf's, so that no device holds more than one leaf at
    its full size."""
    return {n: full_value(t).cpu() if isinstance(t, DTensor) else t
            for n, t in tree.items()}


def _shapes(tree: Dict) -> Dict:
    """Each tensor of a flat dict as a meta tensor of its full shape and
    dtype: a restore's ``tree_like``, which loads onto the host."""
    return {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
            for n, t in tree.items()}


def reference_tree(state: Dict, cfg: ModelConfig, leaves=_full) -> Dict:
    """The training state in the reference's checkpoint tree, each flat
    dict of it through ``leaves`` first (default: full values, on a mesh
    gathered to the host a leaf at a time)."""
    adam = state["opt"]["adam"]
    tree = lambda d: params_to_jax(leaves(d), cfg)
    opt = {"adam": {"mu": tree(adam["mu"]), "nu": tree(adam["nu"]),
                    "step": leaves({"step": adam["step"]})["step"]}}
    if "ef" in state["opt"]:
        opt["ef"] = tree(state["opt"]["ef"])
    return {"params": tree(state["model"].state_dict()), "opt": opt}


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst's values from the full tensor src (on the host): a DTensor
    takes its slice, cut before it moves to the device."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(local_slice(src, dst.device_mesh,
                                         dst.placements).to(dst.device))
    else:
        dst.copy_(src)


@torch.no_grad()
def load_reference_tree(state: Dict, tree: Dict, cfg: ModelConfig) -> None:
    """Copy a restored reference tree (full values, on the host) into
    ``state`` in place, on a mesh each rank its slices."""
    params = dict(state["model"].named_parameters())
    for name, t in params_from_jax(tree["params"], cfg).items():
        _assign(params[name], t)
    adam = state["opt"]["adam"]
    for key in ("mu", "nu"):
        for name, t in params_from_jax(tree["opt"]["adam"][key], cfg).items():
            _assign(adam[key][name], t)
    adam["step"] = tree["opt"]["adam"]["step"].to(adam["step"].device)
    if "ef" in state["opt"]:
        for name, t in params_from_jax(tree["opt"]["ef"], cfg).items():
            _assign(state["opt"]["ef"][name], t)


def device_batch(cfg: ModelConfig, batch_np: Dict[str, Any],
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The pipeline's numpy batch on ``device``, with the stub frontends'
    inputs the config takes: (B, img_tokens, d) image embeddings and (B,
    enc_seq, d) frames, bf16, drawn from generators seeded 0 and 1 on the
    device (the same for every step)."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    B = batch["tokens"].shape[0]
    if cfg.img_tokens:
        g = torch.Generator(device=device).manual_seed(0)
        batch["img_embeds"] = torch.randn(
            B, cfg.img_tokens, cfg.d_model, generator=g,
            device=device).to(torch.bfloat16)
    if cfg.is_encdec:
        g = torch.Generator(device=device).manual_seed(1)
        batch["frames"] = torch.randn(
            B, cfg.enc_seq, cfg.d_model, generator=g,
            device=device).to(torch.bfloat16)
    return batch


def train_loop(run: TrainRunConfig, mesh=None, injector=None,
               fault: FaultConfig = FaultConfig(max_restarts=3,
                                                step_deadline_s=300.0),
               log=print) -> Dict[str, Any]:
    """Run the supervised training loop; returns final state + history.
    ``mesh``: a ``DeviceMesh`` to train on (its device type must be the
    run's device's); None trains the plain model."""
    cfg = run.cfg
    device = resolve_device(run.device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a run on {device}")
    data = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=run.seq_len, global_batch=run.global_batch,
        seed=run.seed + 1))
    mgr = CheckpointManager(run.ckpt_dir) if run.ckpt_dir else None
    history: Dict[str, list] = {"loss": [], "step": []}
    opt_cfg = AdamWConfig(lr=run.lr, moment_dtype=cfg.moment_dtype)

    def init_state():
        model = Transformer(cfg, device, seed=run.seed, trainable=True)
        if mesh is not None:
            steps_lib.distribute_model(model, mesh)
        train_step, opt_init = steps_lib.make_train_step(
            model, opt_cfg, microbatches=run.microbatches,
            grad_compression=run.grad_compression)
        return {"model": model, "opt": opt_init(), "train_step": train_step}

    def step_fn(state, step):
        batch = device_batch(cfg, data.global_batch_at(step), device)
        if mesh is not None:
            with use_mesh(mesh):
                batch = steps_lib.distribute_batch(
                    batch, steps_lib.train_batch_pspecs(cfg), mesh)
        opt, metrics = state["train_step"](state["opt"], batch)
        if step % run.log_every == 0 or step == run.steps - 1:
            loss = float(metrics["loss"])
            history["loss"].append(loss)
            history["step"].append(step)
            log(f"step {step:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}")
        return dict(state, opt=opt)

    def save_fn(state, step):
        if mgr is not None:
            tree = reference_tree(state, cfg)
            if mesh is None or dist.get_rank() == 0:    # one writer
                mgr.save_async(step, tree)

    def restore_fn():
        if mgr is None:
            return None
        mgr.wait()
        if mesh is not None:
            dist.barrier()        # rank 0's last save is committed
        if mgr.latest_step() is None:
            return None
        state = init_state()
        tree, step = mgr.restore(reference_tree(state, cfg, _shapes))
        load_reference_tree(state, tree, cfg)
        return state, step

    try:
        out = run_with_restarts(
            total_steps=run.steps, init_state=init_state, step_fn=step_fn,
            save_fn=save_fn, restore_fn=restore_fn,
            save_every=run.save_every, fault=fault, injector=injector,
            sync=torch.cuda.synchronize if device.type == "cuda" else None)
    finally:
        if mgr is not None:
            mgr.wait()
            if mesh is not None:
                dist.barrier()
    out["history"] = history
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's own)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is no card)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train on a (data, model) mesh of the ranks that "
                         "torchrun launched, e.g. 2x4")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    run = TrainRunConfig(cfg=cfg, steps=args.steps, global_batch=args.batch,
                         seq_len=args.seq, lr=args.lr, seed=args.seed,
                         microbatches=args.microbatches,
                         grad_compression=args.grad_compression,
                         ckpt_dir=args.ckpt_dir, log_every=args.log_every,
                         device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mesh = None
    if args.mesh:
        data, model = (int(n) for n in args.mesh.lower().split("x"))
        mesh = make_local_mesh(data, model, device=args.device)
    t0 = time.time()
    try:
        out = train_loop(run, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    secs = time.time() - t0
    print(f"done: {out['completed_steps']} steps, {out['restarts']} "
          f"restarts, {secs:.1f}s; final loss {out['history']['loss'][-1]:.4f}")
    steps_s = out["watchdog"].durations
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "batch": args.batch, "seq": args.seq, "steps": out["completed_steps"],
        "restarts": out["restarts"], "loss": out["history"]["loss"],
        "mesh": args.mesh,
        "step_ms": [t * 1e3 for t in steps_s],
        # the first step builds the kernels and warms the allocator
        "tokens_per_s": (args.batch * args.seq * (len(steps_s) - 1)
                         / sum(steps_s[1:]) if len(steps_s) > 1 else None),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
