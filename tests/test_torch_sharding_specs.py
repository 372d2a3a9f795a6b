"""The port's sharding specs against the JAX reference's, on the CPU.

For the ten published configs, both sharding modes (``tp``, ``fsdp``) and
the meshes (16, 16), (2, 16, 16), (2, 4) and (1, 1):

- the stacked spec trees (``param_pspecs``, ``cache_pspecs`` with and
  without ``shard_seq``, ``train_batch_pspecs``, ``opt_state_pspecs``,
  ``decode_input_pspecs`` of ``decode_32k`` and ``long_500k``) equal the
  reference's;
- each of the port model's parameters takes its reference leaf's spec
  without the stacked layer axis (``convert.reference_leaf``), and each
  decode cache entry its cache leaf's;
- ``fit_spec`` of each parameter equals the reference's fitted leaf, and
  the parameter's per-device shape equals jax's ``NamedSharding(...)
  .shard_shape`` of the leaf (the layer axis left out);
- on (2, 4), each rank's slice of each parameter (``slice_bounds``, the
  split that ``distribute`` and ``local_slice`` make) equals the leaf's
  ``devices_indices_map`` at that rank's mesh coordinate.

The reference's side is computed once, in a subprocess with 512 fake XLA
host devices (as ``tests/test_dryrun_integration.py`` runs the reference's
dry run): ``eval_shape`` of the params, specs and shardings, no compile.
The port's side needs no process group: the spec functions read only a
mesh's dim names and sizes (and, for a slice, the rank's coordinate), so a
stand-in mesh carries them; the port's model is built under
``FakeTensorMode`` for its parameter names and shapes.
"""
import json
import math
import os
import subprocess
import sys
import types

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.convert import reference_leaf
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.common import (placements, set_sharding_mode,
                                       slice_bounds, use_mesh)

REPO = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4)),
          "1x1": (("data", "model"), (1, 1))}
DECODE_SHAPES = ("decode_32k", "long_500k")

_REFERENCE = r"""
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import steps
from repro.launch.mesh import make_local_mesh, make_production_mesh
from repro.models import transformer as T
from repro.models.common import set_sharding_mode, use_mesh

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}

def specs(tree):
    return {k: enc(v) for k, v in flat(tree).items()}

meshes = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "2x4": make_local_mesh(2, 4), "1x1": make_local_mesh(1, 1)}
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    shapes = flat(jax.eval_shape(
        lambda: T.init_params(cfg, jax.random.PRNGKey(0))))
    for mode in ("tp", "fsdp"):
        set_sharding_mode(mode)
        for name, mesh in meshes.items():
            with use_mesh(mesh):
                pp = flat(T.param_pspecs(cfg))
                fitted = {k: steps.fit_spec(s, shapes[k].shape, mesh)
                          for k, s in pp.items()}
                rec = {
                    "params": {k: enc(s) for k, s in pp.items()},
                    "fitted": {k: enc(s) for k, s in fitted.items()},
                    "shard_shape": {
                        k: list(NamedSharding(mesh, s).shard_shape(
                            shapes[k].shape)) for k, s in fitted.items()},
                    "cache": specs(T.cache_pspecs(cfg)),
                    "cache_seq": specs(T.cache_pspecs(cfg, shard_seq=True)),
                    "batch": specs(steps.train_batch_pspecs(cfg)),
                    "opt": specs(steps.opt_state_pspecs(cfg)),
                    "decode": {s: specs(steps.decode_input_pspecs(
                        cfg, SHAPES[s])) for s in ("decode_32k", "long_500k")},
                }
                if name == "2x4":
                    coord = {d.id: (i, j) for i, row in
                             enumerate(mesh.devices) for j, d in
                             enumerate(row)}
                    rec["indices"] = {}
                    for k, s in fitted.items():
                        shape = shapes[k].shape
                        idx = NamedSharding(mesh, s).devices_indices_map(
                            shape)
                        rec["indices"][k] = {
                            "%d,%d" % coord[d.id]: [
                                [sl.start or 0,
                                 shape[i] if sl.stop is None else sl.stop]
                                for i, sl in enumerate(ix)]
                            for d, ix in idx.items()}
            out["%s|%s|%s" % (arch, mode, name)] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("specs") / "reference.json")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, path], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


class StubMesh:
    """What the spec functions read of a ``DeviceMesh``: dim names, sizes
    and this rank's coordinate."""

    def __init__(self, names, shape, coord=None):
        self.mesh_dim_names = names
        self.mesh = types.SimpleNamespace(shape=shape)
        self.coord = coord or (0,) * len(shape)

    def size(self, m):
        return self.mesh.shape[m]

    def get_local_rank(self, m):
        return self.coord[m]


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): _enc(tree)}


_MODELS = {}


def _port_params(arch):
    """{name: shape} of the port's model of ``arch`` (built on fake
    tensors: nothing is allocated)."""
    if arch not in _MODELS:
        with FakeTensorMode():
            model = T.Transformer(get_config(arch), "cpu")
        _MODELS[arch] = {n: tuple(p.shape)
                         for n, p in model.named_parameters()}
    return _MODELS[arch]


def _ways(entry, sizes):
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(sizes[n] for n in names)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(reference, arch, mode):
    cfg = get_config(arch)
    params = _port_params(arch)
    set_sharding_mode(mode)
    try:
        for mesh_name, (names, shape) in MESHES.items():
            ref = reference[f"{arch}|{mode}|{mesh_name}"]
            mesh = StubMesh(names, shape)
            sizes = dict(zip(names, shape))
            where = f"{arch} {mode} {mesh_name}"
            with use_mesh(mesh):
                assert _flat(T.param_pspecs(cfg)) == ref["params"], where
                assert _flat(T.cache_pspecs(cfg)) == ref["cache"], where
                assert _flat(T.cache_pspecs(cfg, shard_seq=True)) == \
                    ref["cache_seq"], where
                assert _flat(steps.train_batch_pspecs(cfg)) == ref["batch"]
                assert _flat(steps.opt_state_pspecs(cfg)) == ref["opt"]
                for s in DECODE_SHAPES:
                    assert _flat(steps.decode_input_pspecs(cfg, SHAPES[s])) \
                        == ref["decode"][s], (where, s)
                specs = steps.param_specs(cfg, list(params))
                caches = {False: T.cache_specs(cfg),
                          True: T.cache_specs(cfg, shard_seq=True)}
            for name, pshape in params.items():
                keys, r = reference_leaf(name, cfg)
                leaf = "/".join(keys)
                drop = 0 if r is None else 1
                assert _enc(specs[name]) == ref["params"][leaf][drop:], \
                    (where, name)
                fitted = steps.fit_spec(specs[name], pshape, mesh)
                assert _enc(fitted) == ref["fitted"][leaf][drop:], \
                    (where, name)
                local = [n // _ways(e, sizes) for n, e in zip(pshape, fitted)]
                assert local == ref["shard_shape"][leaf][drop:], \
                    (where, name)
                if mesh_name != "2x4":
                    continue
                pl = placements(fitted, mesh)
                for coord, want in ref["indices"][leaf].items():
                    at = StubMesh(names, shape,
                                  tuple(int(c) for c in coord.split(",")))
                    got = [list(b) for b in slice_bounds(pshape, at, pl)]
                    assert got == want[drop:], (where, name, coord)
            for shard_seq, per_layer in caches.items():
                tree = ref["cache_seq" if shard_seq else "cache"]
                for i, layer in enumerate(per_layer):
                    keys, _ = reference_leaf(f"layers.{i}.x", cfg)
                    base = "/".join(keys[1:-1])
                    for entry, spec in layer.items():
                        if entry.startswith("cross_"):
                            continue
                        leaf = f"{base}/attn/{entry}" \
                            if f"{base}/attn/{entry}" in tree \
                            else f"{base}/{entry}"
                        assert _enc(spec) == tree[leaf][1:], \
                            (where, i, entry, shard_seq)
    finally:
        set_sharding_mode("tp")
