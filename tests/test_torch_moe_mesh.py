"""The port's MoE FFN on a (data 2, model 4) mesh of 8 CPU ranks (gloo)
against the reference's ``_moe_apply_a2a`` on a (data 2, model 4) mesh of 8
fake XLA devices, on the same weights and inputs.

On such a mesh both split the 64 tokens of a (4, 16) batch into two groups
of 32, each routed at its own capacity ``ceil(capacity_factor * 32 * K /
E)``.  The capacity factor is the published configs' 1.25 (the reduced
configs' own 2.0 is E / K for dbrx, where nothing drops), and the tokens
share a random direction, as hidden states do, which skews the routing:
dbrx's groups keep 106 of 128 picks and llama4's 38 of 64.  Reduced dbrx-132b (4 experts, top 2) and
llama4-maverick-400b-a17b (4 experts, top 1, the shared expert), fp32:

- the kept picks of each group equal the reference's, by its rule on its
  own routing (and differ from what one group of 64 would keep: the mesh
  changes the picks, and the test sees it);
- the output and the aux loss within 2e-4, and the gradients of a fixed
  linear function of the output plus the aux loss, with respect to the
  router, the experts, the shared expert and the input, within 2e-4 (the
  sharded training test's tolerance).

The reference runs in a subprocess with 8 host devices, as
``tests/test_dryrun_integration.py`` runs it; the ranks run the ``moe``
case of ``tests/test_torch_sharded_train.py``, that file run as a script.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_sharded_train import MOE_ARCHS, _run_ranks

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL = 2e-4

_REFERENCE = r"""
import dataclasses, json, math, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, get_reduced
from repro.launch.mesh import make_local_mesh
from repro.models.common import use_mesh
from repro.models.moe import _moe_apply_a2a, moe_init

out_dir, archs = sys.argv[1], sys.argv[2].split(",")
B, S, G = 4, 16, 2

def kept(sel, cap):
    # the reference's rule: rank in the stable sort by expert below cap
    flat = sel.reshape(-1)
    order = np.argsort(flat, kind="stable")
    e = flat[order]
    start = np.r_[True, e[1:] != e[:-1]]
    seg = np.maximum.accumulate(np.where(start, np.arange(flat.size), 0))
    return np.sort(order[np.arange(flat.size) - seg < cap]).tolist()

mesh = make_local_mesh(2, 4)
picks = {}
for i, arch in enumerate(archs):
    cfg = dataclasses.replace(
        get_reduced(arch), param_dtype="float32", moe_impl="a2a",
        capacity_factor=get_config(arch).capacity_factor)
    params = moe_init(jax.random.PRNGKey(i), cfg, jnp.float32)
    rng = np.random.default_rng(10 + i)
    # a direction every token shares, as hidden states have, skews the
    # routing: the groups drop picks
    x = (rng.normal(size=(B, S, cfg.d_model))
         + rng.normal(size=cfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def loss(p, x):
        y, aux = _moe_apply_a2a(p, x, cfg)
        return jnp.sum(y * w) + aux

    with use_mesh(mesh):
        y, aux = jax.jit(lambda p, x: _moe_apply_a2a(p, x, cfg))(params, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    grads = {"grad/" + "/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(gp)}
    np.savez(f"{out_dir}/moe_{arch}.npz", x=x, w=w, y=np.asarray(y),
             aux=np.asarray(aux), gx=np.asarray(gx), **flat, **grads)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                           @ params["router"], axis=-1)
    sel = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    E, K, N = cfg.n_experts, cfg.top_k, B * S
    nl = N // G
    cap = math.ceil(cfg.capacity_factor * nl * K / E)
    picks[arch] = {
        "groups": [kept(sel[g * nl:(g + 1) * nl], cap) for g in range(G)],
        "one_group": kept(sel, math.ceil(cfg.capacity_factor * N * K / E)),
        "picks": N * K}
json.dump(picks, open(f"{out_dir}/moe_reference.json", "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's picks, the ranks' results), each run once."""
    out = tmp_path_factory.mktemp("moe_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                          ",".join(MOE_ARCHS)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out / "moe_reference.json") as f:
        ref = json.load(f)
    return ref, _run_ranks("moe", str(out)), out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_on_mesh_matches_reference(runs, arch):
    ref, got, out = runs
    ref, got = ref[arch], got[arch]
    kept = [p for g in ref["groups"] for p in g]
    assert 0 < len(kept) < ref["picks"], "no pick dropped: nothing to test"
    # one group of all the tokens would keep other picks (a group's pick
    # p is pick p + g * nl * K of the whole batch)
    per_group = ref["picks"] // len(ref["groups"])
    assert sorted(p + g * per_group for g, grp in enumerate(ref["groups"])
                  for p in grp) != ref["one_group"]
    assert got["groups"] == ref["groups"]
    with np.load(out / f"moe_{arch}.npz") as want, \
            np.load(out / f"moe_{arch}_port.npz") as port:
        np.testing.assert_allclose(port["y"], want["y"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(port["aux"], want["aux"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(port["gx"], want["gx"], rtol=TOL,
                                   atol=TOL)
        grads = sorted(k for k in want.files if k.startswith("grad/"))
        assert grads == sorted(k for k in port.files
                               if k.startswith("grad/"))
        assert "grad/router" in grads and "grad/w_down" in grads
        for k in grads:
            np.testing.assert_allclose(port[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
