"""The port's sharded training on 8 CPU ranks (gloo) against the JAX
reference, the counterparts of ``tests/test_system.py``'s sharded and
elastic tests (the elastic one in ``tests/test_torch_elastic_remesh.py``).

- Reduced qwen2-7b in fp32, 8 steps of 8 x 32 tokens at lr 1e-3, on a
  (data 2, model 4) mesh: from the reference's initial weights
  (``params_from_jax(..., mesh=)``) through ``make_train_step``, the losses
  within rtol/atol 2e-4 of the reference's ``train_loop`` on a (1, 1) mesh
  (``tests/test_system.py``'s tolerance); and ``train_loop(run, mesh)``
  from the port's own initial weights within 2e-4 of ``train_loop(run)``
  with no mesh.
- The elastic remesh of ``tests/helpers/elastic_remesh_check.py``: reduced
  stablelm-1.6b crashes at step 8 on (2, 4) with no restart left, a new
  run resumes from its step-6 checkpoint on (4, 2) and finishes 12 steps;
  its last 3 losses within 3e-4 and its parameters within 2e-4 of an
  uninterrupted run with no mesh.  The reference's ``load_checkpoint``
  reads the last checkpoint the sharded run wrote, and finds the sharded
  run's final parameters in it.

Each case runs this file as a script, which spawns the 8 ranks (they import
no JAX) on a free port with a 120 s collective timeout; the test kills the
script's whole process group if it outlives its limit.  The ``elastic``
and ``serve`` cases (``tests/test_torch_elastic_remesh.py`` and
``tests/test_torch_sharded_serve.py`` run them, apart, so that the suite's
workers share the time) live here with the rest of the ranks' code.
"""
import dataclasses
import datetime
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORLD = 8
SCRIPT_LIMIT_S = 300
# served on the mesh beside the training case: dense GQA whose two KV heads
# do not divide the model axis (the cache splits its sequence), and the MoE
SERVED = ("qwen2-7b", "dbrx-132b")
# the MoE layer on the mesh against the reference's (test_torch_moe_mesh.py)
MOE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
SERVE_TOKENS = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(case: str, out_dir: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, out_dir,
         str(_free_port())], env=env, cwd=REPO, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=SCRIPT_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{case}: the ranks outlived {SCRIPT_LIMIT_S} s")
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    with open(os.path.join(out_dir, f"{case}.json")) as f:
        return json.load(f)


# ---- the ranks (no JAX here) ----

def _quiet(*a):
    pass


def _fp32(arch):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), param_dtype="float32",
                               compute_dtype="float32")


def _load_tree(path: str) -> dict:
    """The nested dict of arrays saved flat under ``/``-joined paths."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            *keys, leaf = key.split("/")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return tree


def _case_qwen(rank: int, out_dir: str) -> None:
    from repro_torch.convert import params_from_jax
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (distribute_batch, distribute_model,
                                          make_train_step, train_batch_pspecs)
    from repro_torch.launch.train import (TrainRunConfig, device_batch,
                                          train_loop)
    from repro_torch.models.common import use_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamWConfig
    cfg = _fp32("qwen2-7b")
    run = TrainRunConfig(cfg=cfg, steps=8, global_batch=8, seq_len=32,
                         lr=1e-3, log_every=1, device="cpu")
    mesh = make_local_mesh(2, 4, device="cpu")
    sharded = train_loop(run, mesh, log=_quiet)["history"]["loss"]
    plain = train_loop(run, log=_quiet)["history"]["loss"]

    # the reference's initial weights, placed onto the mesh
    tree = _load_tree(os.path.join(out_dir, "ref_params.npz"))
    model = distribute_model(Transformer(cfg, "cpu", trainable=True), mesh)
    model.load_state_dict(params_from_jax(tree, cfg, mesh=mesh))
    step, opt_init = make_train_step(model, AdamWConfig(lr=1e-3))
    opt = opt_init()
    data = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                             global_batch=8, seed=1))
    from_ref = []
    for s in range(8):
        batch = device_batch(cfg, data.global_batch_at(s),
                             torch.device("cpu"))
        with use_mesh(mesh):
            batch = distribute_batch(batch, train_batch_pspecs(cfg), mesh)
        opt, m = step(opt, batch)
        from_ref.append(float(m["loss"]))
    if rank == 0:
        with open(os.path.join(out_dir, "qwen.json"), "w") as f:
            json.dump({"sharded": sharded, "plain": plain,
                       "from_reference": from_ref}, f)


def _case_serve(rank: int, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 4, device="cpu")
    serve = {arch: _serve_both(arch, mesh) for arch in SERVED}
    for arch in SERVED:
        _serve_reference_weights(rank, arch, mesh, out_dir)
    if rank == 0:
        with open(os.path.join(out_dir, "serve.json"), "w") as f:
            json.dump(serve, f)


def _serve_both(arch: str, mesh) -> dict:
    """Greedy ``generate`` of a reduced fp32 model with no mesh and on
    ``mesh`` (the same weights and prompts; the MoE at capacity E / K, where
    neither drops a pick): the tokens and the logits' largest gap."""
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import distribute, distribute_model
    from repro_torch.models.common import BATCH, pspec, use_mesh
    from repro_torch.models.transformer import Transformer
    cfg = _fp32(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    g = torch.Generator().manual_seed(0)
    model = Transformer(cfg, "cpu", generator=g)
    prompts = torch.randint(0, cfg.vocab, (4, 12), generator=g)
    with torch.no_grad():
        plain = generate(model, prompts, SERVE_TOKENS)
        distribute_model(model, mesh)
        with use_mesh(mesh):
            dprompts = distribute(prompts, mesh, pspec(BATCH, None))
        sharded = generate(model, dprompts, SERVE_TOKENS)
    tokens = sharded.tokens.full_tensor()
    logits = sharded.logits.full_tensor()
    return {"tokens_equal": bool(torch.equal(tokens, plain.tokens)),
            "logits_max_abs_diff": float((logits - plain.logits).abs().max())}


def _case_moe(rank: int, out_dir: str) -> None:
    """Each of MOE_ARCHS' MoE layer on (2, 4) from the reference's weights
    and inputs (``tests/test_torch_moe_mesh.py`` writes them): the kept
    picks of each group, the output, the aux loss, and the gradients of
    sum(y * w) + aux."""
    from repro_torch.configs import get_config
    from repro_torch.convert import _flatten
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import BATCH, pspec, use_mesh
    from repro_torch.models.moe import MoE, moe_param_specs, route_on_mesh
    from repro_torch.models.transformer import distribute
    mesh = make_local_mesh(2, 4, device="cpu")
    res = {}
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(
            _fp32(arch), capacity_factor=get_config(arch).capacity_factor)
        with np.load(os.path.join(out_dir, f"moe_{arch}.npz")) as z:
            data = {k: torch.from_numpy(z[k]) for k in z.files}
        moe = MoE(cfg, torch.float32, "cpu", torch.Generator())
        with use_mesh(mesh):
            specs = _flatten(moe_param_specs(cfg))
            for name, p in list(moe.named_parameters()):
                mod_name, _, leaf = name.rpartition(".")
                mod = moe.get_submodule(mod_name) if mod_name else moe
                mod._parameters[leaf] = torch.nn.Parameter(distribute(
                    data[name.replace(".", "/")], mesh, specs[name]))
            x = distribute(data["x"], mesh, pspec(BATCH, None, None))
            w = distribute(data["w"], mesh, pspec(BATCH, None, None))
            x.requires_grad_(True)
            r = route_on_mesh(moe, x)
            order, keep = r.order.full_tensor(), r.keep.full_tensor()
            y, aux = moe(x)
            ((y * w).sum() + aux).backward()
            grads = {"grad/" + n.replace(".", "/"): p.grad.full_tensor()
                     for n, p in moe.named_parameters()}
            out = {"y": y.full_tensor(), "aux": aux.full_tensor(),
                   "gx": x.grad.full_tensor(), **grads}
        res[arch] = {"groups": [sorted(order[g][keep[g]].tolist())
                                for g in range(r.G)]}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"moe_{arch}_port.npz"),
                     **{k: v.detach().numpy() for k, v in out.items()})
    if rank == 0:
        with open(os.path.join(out_dir, "moe.json"), "w") as f:
            json.dump(res, f)


def _serve_reference_weights(rank: int, arch: str, mesh,
                             out_dir: str) -> None:
    """Greedy ``generate`` on ``mesh`` of a reduced fp32 model from the
    reference's weights and prompts (``tests/test_torch_sharded_serve.py``
    writes them), the MoE at the published capacity factor: rank 0 writes
    the tokens and logits."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import distribute, distribute_model
    from repro_torch.models.common import BATCH, pspec, use_mesh
    from repro_torch.models.transformer import Transformer
    cfg = _fp32(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=get_config(arch).capacity_factor)
    tree = _load_tree(os.path.join(out_dir, f"serve_{arch}.npz"))
    prompts = torch.from_numpy(tree.pop("prompts")).long()
    model = distribute_model(Transformer(cfg, "cpu"), mesh)
    model.load_state_dict(params_from_jax(tree, cfg, mesh=mesh))
    with torch.no_grad(), use_mesh(mesh):
        out = generate(model, distribute(prompts, mesh, pspec(BATCH, None)),
                       SERVE_TOKENS)
    tokens, logits = out.tokens.full_tensor(), out.logits.full_tensor()
    if rank == 0:
        np.savez(os.path.join(out_dir, f"serve_{arch}_port.npz"),
                 tokens=tokens.numpy(), logits=logits.numpy())


def _case_elastic(rank: int, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import TrainRunConfig, train_loop
    from repro_torch.runtime import FaultConfig, FaultInjector
    base = dict(cfg=_fp32("stablelm-1.6b"), steps=12, global_batch=8,
                seq_len=32, lr=1e-3, save_every=6, log_every=1, device="cpu")
    ck = os.path.join(out_dir, "ck")
    crashed = False
    try:
        train_loop(TrainRunConfig(ckpt_dir=ck, **base),
                   make_local_mesh(2, 4, device="cpu"),
                   injector=FaultInjector(fail_at_steps=[8]),
                   fault=FaultConfig(max_restarts=0), log=_quiet)
    except Exception:
        crashed = True              # as planned, with no restart budget
    resumed = train_loop(TrainRunConfig(ckpt_dir=ck, **base),
                         make_local_mesh(4, 2, device="cpu"), log=_quiet)
    oracle = train_loop(TrainRunConfig(ckpt_dir=None, **base), log=_quiet)
    params = {n: p.full_tensor() for n, p in
              resumed["state"]["model"].named_parameters()}
    if rank == 0:
        want = dict(oracle["state"]["model"].named_parameters())
        np.savez(os.path.join(out_dir, "final.npz"),
                 **{n: t.detach().numpy() for n, t in params.items()})
        with open(os.path.join(out_dir, "elastic.json"), "w") as f:
            json.dump({
                "crashed": crashed,
                "resumed": resumed["history"]["loss"],
                "resumed_steps": resumed["history"]["step"],
                "oracle": oracle["history"]["loss"],
                "params_not_close": [
                    n for n, t in params.items()
                    if not torch.allclose(t, want[n].detach(), rtol=2e-4,
                                          atol=2e-4)]}, f)


CASES = {"qwen": _case_qwen, "elastic": _case_elastic, "serve": _case_serve,
         "moe": _case_moe}


def _rank_main(rank: int, case: str, out_dir: str, port: int) -> None:
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            timeout=datetime.timedelta(seconds=120))
    try:
        CASES[case](rank, out_dir)
    finally:
        dist.destroy_process_group()


# ---- the tests (the reference runs here) ----

def _reference_qwen(tmp_path):
    """(the reference's losses on (1, 1), its initial weights written for
    the ranks)."""
    import jax
    from repro.configs import get_reduced
    from repro.launch.mesh import make_local_mesh
    from repro.launch.train import TrainRunConfig, train_loop
    from repro.models import transformer as T
    from repro.models.common import ensure_sharding_invariant_rng
    cfg = dataclasses.replace(get_reduced("qwen2-7b"), param_dtype="float32",
                              compute_dtype="float32")
    ensure_sharding_invariant_rng()
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp_path / "ref_params.npz", **flat)
    run = TrainRunConfig(cfg=cfg, steps=8, global_batch=8, seq_len=32,
                         lr=1e-3, log_every=1)
    out = train_loop(run, mesh=make_local_mesh(1, 1), log=_quiet)
    return out["history"]["loss"]


def test_sharded_qwen_matches_reference_single_device(tmp_path):
    ref = _reference_qwen(tmp_path)
    got = _run_ranks("qwen", str(tmp_path))
    np.testing.assert_allclose(got["from_reference"], ref, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got["sharded"], got["plain"], rtol=2e-4,
                               atol=2e-4)
    assert len(got["sharded"]) == 8


if __name__ == "__main__":
    import torch.multiprocessing as mp
    case, out_dir, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
    mp.spawn(_rank_main, args=(case, out_dir, port), nprocs=WORLD,
             join=True)
