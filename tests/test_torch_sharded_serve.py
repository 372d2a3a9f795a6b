"""Serving on 8 CPU ranks (gloo): greedy ``generate`` through the sharded
prefill and decode steps on a (data 2, model 4) mesh, for reduced qwen2-7b
(its two KV heads do not divide the model axis, so its decode cache splits
the sequence over ``model``) and reduced dbrx-132b (the MoE's grouped
dispatch on the mesh), in fp32:

- against the reference's ``prefill`` and ``decode_step`` on a (data 2,
  model 4) mesh of 8 fake XLA devices, from the reference's weights and
  prompts, the MoE at the published capacity factor 1.25: the same tokens,
  and logits within 1e-4;
- against the port's plain path on the same weights, the MoE at a
  capacity of E / K, where neither path drops a pick (the mesh's groups
  and the plain path's one group keep other picks when they drop): the
  same tokens, and logits within 1e-4.

The reference runs in a subprocess with 8 host devices; the ranks run the
``serve`` case of ``tests/test_torch_sharded_train.py``, that file run as a
script, which spawns them.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_sharded_train import SERVE_TOKENS, SERVED, _run_ranks

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL = 1e-4

_REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs import get_config, get_reduced
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import fit_sharding_tree
from repro.models import transformer as T
from repro.models.common import BATCH, pspec, use_mesh

out_dir, archs, new = sys.argv[1], sys.argv[2].split(","), int(sys.argv[3])
B, S = 4, 12
mesh = make_local_mesh(2, 4)
for i, arch in enumerate(archs):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32",
                              compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=get_config(arch).capacity_factor)
    params = T.init_params(cfg, jax.random.PRNGKey(i))
    prompts = np.random.default_rng(i).integers(0, cfg.vocab, (B, S))
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(f"{out_dir}/serve_{arch}.npz", prompts=prompts, **flat)
    with use_mesh(mesh):
        specs = fit_sharding_tree(mesh, T.param_pspecs(cfg), params)
        p = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, PartitionSpec)))
        toks = jax.device_put(jnp.asarray(prompts, jnp.int32),
                              NamedSharding(mesh, pspec(BATCH, None)))
        prefill = jax.jit(lambda p, t: T.prefill(
            p, cfg, {"tokens": t}, max_len=S + new,
            cache_dtype=jnp.float32)[:2])
        decode = jax.jit(lambda p, tok, pos, c: T.decode_step(
            p, cfg, tok, pos, c))
        lg, caches = prefill(p, toks)
        logits = [lg[:, 0]]
        for j in range(new - 1):
            cur = jnp.argmax(logits[-1], -1)[:, None].astype(jnp.int32)
            lg, caches = decode(p, cur, jnp.int32(S + j), caches)
            logits.append(lg[:, 0])
    logits = np.stack([np.asarray(l) for l in logits], 1)
    np.savez(f"{out_dir}/serve_{arch}_reference.npz",
             tokens=logits.argmax(-1), logits=logits)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' comparisons with the plain path, the directory of both
    sides' tokens and logits), each side run once."""
    out = tmp_path_factory.mktemp("serve")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                          ",".join(SERVED), str(SERVE_TOKENS)], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return _run_ranks("serve", str(out)), out


def test_sharded_generate_matches_plain(runs):
    got, _ = runs
    assert sorted(got) == sorted(SERVED)
    for arch, res in got.items():
        assert res["tokens_equal"], (arch, res)
        assert res["logits_max_abs_diff"] < TOL, (arch, res)


@pytest.mark.parametrize("arch", SERVED)
def test_sharded_generate_matches_reference(runs, arch):
    _, out = runs
    with np.load(out / f"serve_{arch}_reference.npz") as want, \
            np.load(out / f"serve_{arch}_port.npz") as port:
        assert port["tokens"].shape == (4, SERVE_TOKENS)
        np.testing.assert_array_equal(port["tokens"], want["tokens"])
        np.testing.assert_allclose(port["logits"], want["logits"], rtol=TOL,
                                   atol=TOL)
