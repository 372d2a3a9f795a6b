"""The port's checkpoints against the JAX reference's on the CPU: its own
round trip, atomicity, retention, crc check and async save; the on-disk
format in both directions (a checkpoint written by the reference, zstd and
raw, with bf16 leaves, loaded by the port bit for bit, and one written by
the port loaded by ``repro.checkpoint.load_checkpoint``); the leaf names of
a training state (``params_to_jax``, the inverse of ``params_from_jax``);
and a training state written by the reference's ``train_loop`` restored
into the port's."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.configs import get_reduced as jax_reduced
from repro.launch.train import TrainRunConfig as JaxRun
from repro.launch.train import train_loop as jax_train_loop
from repro.models import transformer as T
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.convert import decayed, params_from_jax, params_to_jax
from repro_torch.launch.train import (TrainRunConfig, load_reference_tree,
                                      reference_tree, train_loop)


def _bits(t) -> np.ndarray:
    """The bytes of a tensor or array, as unsigned integers of its width."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    else:
        a = np.asarray(t)
    return a.reshape(-1).view(f"u{a.dtype.itemsize}").reshape(a.shape)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "b": torch.randn(3, generator=g).to(torch.bfloat16),
                       "layers": [torch.arange(5, dtype=torch.int32),
                                  torch.randn(2, 2, generator=g)]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _like(tree):
    return jax.tree.map(torch.zeros_like, tree)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_round_trip_and_names(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 3, tree)
    assert os.path.basename(path) == "step_00000003"
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    # the reference's flatten order and names: sorted keys, list indices
    assert [m["name"] for m in man["leaves"]] == [
        "params/b", "params/layers/0", "params/layers/1", "params/w", "step"]
    assert [m["file"] for m in man["leaves"]] == [
        f"leaf_{i:05d}.npy" for i in range(5)]
    assert {m["codec"] for m in man["leaves"]} == {"raw"}
    assert man["leaves"][0]["dtype"] == "bfloat16"
    back, step = load_checkpoint(str(tmp_path), _like(tree))
    assert step == 3
    for (p, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), p


def test_atomic_commit_and_retention(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        save_checkpoint(d, s, _tree(), keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a crashed save
    os.makedirs(os.path.join(d, "step_00000008"))       # no manifest
    assert latest_step(d) == 4
    assert load_checkpoint(d, _like(_tree()))[1] == 4
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), _like(_tree()))


def test_crc_corruption_detected(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, _tree())
    leaf = os.path.join(path, "leaf_00003.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0x01
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch for params/w"):
        load_checkpoint(str(tmp_path), _like(_tree()))


def test_shape_mismatch_and_unknown_codec(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros(3, 2)})
    man = tmp_path / "step_00000001" / "manifest.json"
    m = json.loads(man.read_text())
    m["leaves"][0]["codec"] = "lz4"
    man.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="codec 'lz4'"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros(2, 3)})


def test_zstd_without_zstandard_names_the_codec(tmp_path, monkeypatch):
    jax_ckpt.save_checkpoint(str(tmp_path), 1, {"w": jnp.ones(3)})
    import builtins
    real = builtins.__import__

    def no_zstd(name, *a, **k):
        if name == "zstandard":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_zstd)
    with pytest.raises(RuntimeError, match="codec 'zstd'"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros(3)})


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.full((16,), 3.0)}
    mgr.save_async(1, tree)
    tree["w"].add_(1.0)            # an in-place update after the call
    mgr.wait()
    assert mgr.latest_step() == 1
    back, step = mgr.restore({"w": torch.zeros(16)})
    assert step == 1 and torch.equal(back["w"], torch.full((16,), 3.0))
    mgr.save_async(2, tree)
    mgr.save_async(3, tree)        # waits for the previous save
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]


def _jax_tree():
    k = jax.random.PRNGKey(0)
    return {"params": {"w": jax.random.normal(k, (4, 3)),
                       "b": jax.random.normal(k, (3,)).astype(jnp.bfloat16),
                       "layers": [jnp.arange(5, dtype=jnp.int32),
                                  jax.random.normal(k, (2, 2))]},
            "step": jnp.int32(7)}


@pytest.mark.parametrize("compress", [True, False])
def test_reference_checkpoint_loads_in_the_port(tmp_path, compress):
    tree = _jax_tree()
    jax_ckpt.save_checkpoint(str(tmp_path), 5, tree, compress=compress)
    like = jax.tree.map(
        lambda a: torch.zeros(a.shape, dtype={
            "float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[a.dtype.name]), tree)
    back, step = load_checkpoint(str(tmp_path), like)
    assert step == 5
    for (p, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        assert str(b.dtype).endswith(a.dtype.name), p
        assert np.array_equal(_bits(b), _bits(np.asarray(a))), p


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 2, tree)
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, {
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int32: jnp.int32}[t.dtype]), tree)
    back, step = jax_ckpt.load_checkpoint(str(tmp_path), like)
    assert step == 2
    for (p, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        assert np.array_equal(_bits(a), _bits(np.asarray(b))), p


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_to_jax_inverts_params_from_jax(arch):
    """Every leaf's path, shape, dtype and bits, at every config's reduced
    size in its own dtypes (bf16 and the fp32 leaves)."""
    jcfg = jax_reduced(arch)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(0)))
    state = params_from_jax(np_params, get_reduced(arch))
    back = params_to_jax(state, get_reduced(arch))
    want, got = _leaves(np_params), _leaves(back)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (p, a), (_, b) in zip(want, got):
        assert tuple(b.shape) == a.shape, p
        assert np.array_equal(_bits(b), _bits(a)), p
    # weight decay by the reference's rule, ndim >= 2 of its own leaf: the
    # same elements decay
    dec = decayed(state)
    assert sum(state[n].numel() for n in state if dec[n]) == \
        sum(a.size for _, a in want if a.ndim >= 2)
    assert not dec["final_norm.scale"]
    assert all(dec[n] for n in state if n.startswith("layers."))


def test_reference_train_state_restores_into_the_port(tmp_path):
    """The reference's ``train_loop`` saves its state; the port restores it
    by name into its own state, bit for bit, and saves it back in a form
    the reference restores bit for bit."""
    jcfg = dataclasses.replace(jax_reduced("qwen2-7b"), param_dtype="float32")
    out = jax_train_loop(JaxRun(cfg=jcfg, steps=2, global_batch=2, seq_len=8,
                                save_every=2, log_every=100,
                                ckpt_dir=str(tmp_path / "ref")),
                         log=lambda *a: None)
    want = jax.tree.map(np.asarray, out["state"])
    tcfg = dataclasses.replace(get_reduced("qwen2-7b"), param_dtype="float32")
    run = TrainRunConfig(cfg=tcfg, steps=2, global_batch=2, seq_len=8,
                         device="cpu", ckpt_dir=str(tmp_path / "port"))
    # a fresh port state, the reference's checkpoint restored into it
    from repro_torch.launch.train import steps_lib
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamWConfig
    model = Transformer(tcfg, "cpu", trainable=True)
    _, opt_init = steps_lib.make_train_step(model, AdamWConfig())
    state = {"model": model, "opt": opt_init()}
    mgr = CheckpointManager(str(tmp_path / "ref"))
    tree, step = mgr.restore(reference_tree(state, tcfg))
    assert step == 1
    load_reference_tree(state, tree, tcfg)
    got = reference_tree(state, tcfg)
    for (p, a), (_, b) in zip(_leaves(want), _leaves(got)):
        assert np.array_equal(_bits(b), _bits(a)), jax.tree_util.keystr(p)
    save_checkpoint(run.ckpt_dir, 1, got)
    like = jax.tree.map(jnp.zeros_like, out["state"])
    back, _ = jax_ckpt.load_checkpoint(run.ckpt_dir, like)
    for (p, a), (_, b) in zip(_leaves(want), _leaves(back)):
        assert np.array_equal(_bits(np.asarray(b)), _bits(a)), p
    # and the port's own loop resumes from it: one more step, no restart
    res = train_loop(dataclasses.replace(run, steps=3), log=lambda *a: None)
    assert res["restarts"] == 0 and res["completed_steps"] == 3
    assert int(res["state"]["opt"]["adam"]["step"]) == 3
