"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

Each cell runs in a subprocess, as ``tests/test_dryrun_integration.py``
runs the reference's: the reference's two integration cells, reduced, on
the (2, 4) local mesh of fake ranks (qwen2-7b ``train_4k``, dense; dbrx-132b
``decode_32k``, MoE with its KV cache), and qwen2-7b ``prefill_32k`` and
``train_4k`` in ``fsdp`` mode.  The dry run traces the mesh's last rank,
whose queries sit past the first under ``fsdp``'s sequence split: its
training step is ``refused`` (the card's flash backward takes no query
offset), with the kernel's reason.  Every other artifact must say ``ok``
and carry the reference's keys, positive FLOPs and bytes, a collective
count, the temp bytes and the extrapolation's points.  Every artifact's
``argument_size_bytes`` must equal the bytes of the same arguments under
the reference's specs (jax's ``NamedSharding.shard_shape`` on 8 fake XLA
devices, in a subprocess).  For
a dense config at 4 layers the two-point extrapolation equals the
full-depth trace.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
KEYS = ("status", "chips", "memory", "cost", "collectives", "n_params",
        "n_active_params", "tokens")

_REFERENCE = r"""
import dataclasses, json, math, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import SHAPES, get_reduced
from repro.launch import steps
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as T
from repro.models.common import pspec, set_sharding_mode, use_mesh

def local_bytes(mesh, spec, shape, dtype):
    spec = steps.fit_spec(spec, shape, mesh)
    return math.prod(NamedSharding(mesh, spec).shard_shape(shape)) * \
        jnp.dtype(dtype).itemsize

def leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))

mesh = make_local_mesh(2, 4)
out = {}
for arch, sname, mode in (("qwen2-7b", "train_4k", "tp"),
                          ("qwen2-7b", "train_4k", "fsdp"),
                          ("qwen2-7b", "prefill_32k", "fsdp"),
                          ("dbrx-132b", "decode_32k", "tp")):
    set_sharding_mode(mode)
    cfg = get_reduced(arch)
    shape = dataclasses.replace(SHAPES[sname], seq_len=64, global_batch=4)
    with use_mesh(mesh):
        pshapes = jax.eval_shape(lambda: T.init_params(cfg,
                                                       jax.random.PRNGKey(0)))
        pspecs = T.param_pspecs(cfg)
        params = [local_bytes(mesh, s, x.shape, x.dtype) for s, x in
                  zip(leaves(pspecs), jax.tree_util.tree_leaves(pshapes))]
        total = sum(params)
        inputs = T.input_specs(cfg, shape)
        if shape.kind == "train":
            total += 2 * sum(
                local_bytes(mesh, s, x.shape, cfg.moment_dtype)
                for s, x in zip(leaves(pspecs),
                                jax.tree_util.tree_leaves(pshapes)))
            total += 4                                   # the step count
            bspecs = steps.train_batch_pspecs(cfg)
            total += sum(local_bytes(mesh, bspecs[k], v.shape, v.dtype)
                         for k, v in inputs.items())
        elif shape.kind == "prefill":
            total += sum(local_bytes(mesh, pspec(("pod", "data"), *[None] *
                                                 (len(v.shape) - 1)),
                                     v.shape, v.dtype)
                         for v in inputs.values())
        else:
            specs = steps.decode_input_pspecs(cfg, shape)
            total += local_bytes(mesh, specs["token"], inputs["token"].shape,
                                 inputs["token"].dtype) + 4
            cs = dict(jax.tree_util.tree_leaves_with_path(
                specs["caches"], is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)))
            for path, x in jax.tree_util.tree_leaves_with_path(
                    inputs["caches"]):
                if path[-1].key in ("k", "v"):   # the port keeps no kpos
                    total += local_bytes(mesh, cs[path], x.shape, x.dtype)
    out["%s|%s|%s" % (arch, sname, mode)] = total
json.dump(out, open(sys.argv[1], "w"))
"""

_DEPTH = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.launch import dryrun as D
cfg = dataclasses.replace(get_reduced("qwen2-7b"), n_layers=4)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
mesh = D._mesh("local")
full = D._trace(cfg, shape, mesh, 1, False)
a, b, reps = D._depth_points(cfg)
ext = D._combine_costs(D._trace(a, shape, mesh, 1, False),
                       D._trace(b, shape, mesh, 1, False), reps)
json.dump({"full": {"cost": full["cost"],
                    "collectives": full["collectives"]},
           "extrapolated": ext, "reps": reps}, open(sys.argv[1], "w"))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


@pytest.fixture(scope="module")
def reference_bytes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "bytes.json")
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", _REFERENCE, path], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _run_cell(arch, shape, tmp, *extra):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "local", "--reduced", "--out", tmp,
         *extra], env=_env(), capture_output=True, text=True, timeout=600,
        cwd=REPO)
    assert res.returncode == 0, \
        f"stdout:{res.stdout}\nstderr:{res.stderr[-3000:]}"
    with open(os.path.join(tmp, f"{arch}__{shape}__local.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape,mode", [
    ("qwen2-7b", "train_4k", "tp"),          # dense train step
    ("dbrx-132b", "decode_32k", "tp"),       # MoE decode with KV cache
    ("qwen2-7b", "train_4k", "fsdp"),        # ZeRO-3 + sequence parallel
    ("qwen2-7b", "prefill_32k", "fsdp"),
])
def test_dryrun_cell_reports(reference_bytes, arch, shape, mode, tmp_path):
    art = _run_cell(arch, shape, str(tmp_path), "--sharding", mode)
    assert all(k in art for k in KEYS), sorted(art)
    assert art["chips"] == 8 and art["sharding"] == mode
    assert art["memory"]["argument_size_bytes"] == \
        reference_bytes[f"{arch}|{shape}|{mode}"]
    if (shape, mode) == ("train_4k", "fsdp"):
        # the last rank's queries sit at an offset the backward refuses
        assert art["status"] == "refused", art.get("reason")
        assert "q_offset" in art["reason"] and art["cost"] is None
        return
    assert art["status"] == "ok"
    assert art["cost"]["flops"] > 0
    assert art["cost"]["bytes accessed"] > 0
    assert art["collectives"]["count"] > 0       # 8 ranks talk
    assert art["memory"]["temp_size_bytes"] is not None
    assert art["cost_points"]["reps_full"] >= 2
    assert art["cost"]["flops"] >= art["cost_points"]["a"]["flops"]
    assert art["counts"]["exact"] == ["memory.argument_size_bytes"]
    # the card's route: the kernels' work, no plain version traced
    assert any(k.startswith("flash_attention") for k in art["kernels"])
    if shape == "train_4k":
        assert "flash_attention_bwd_simt" in art["kernels"]
        assert art["kernels"]["rmsnorm_bwd"]["calls"] == \
            art["kernels"]["rmsnorm"]["calls"]


def test_extrapolation_equals_full_depth(tmp_path):
    path = str(tmp_path / "depth.json")
    res = subprocess.run([sys.executable, "-c", _DEPTH, path], env=_env(),
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path) as f:
        got = json.load(f)
    assert got["reps"] == 4
    assert got["extrapolated"]["cost"] == got["full"]["cost"]
    assert got["extrapolated"]["collectives"] == got["full"]["collectives"]
