"""The port's training path against the JAX reference on the CPU, fp32.

- The loss and every parameter's gradient of each of the ten configs
  (reduced; recurrentgemma-2b's window and falcon-mamba-7b's scan
  included) against ``jax.value_and_grad`` of the reference's
  ``loss_fn``, on equal weights (``params_from_jax``; norm scales, biases
  and QKV biases perturbed, which are 1 and 0 at init and would hide a
  wrong gradient) and an equal batch (image embeddings and frames where the
  config takes them, a ``loss_mask``).  Tolerance: the loss within 1e-5
  relative; each gradient leaf within a relative RMS error of 1e-4 (the
  port keeps attention's probabilities in fp32 where the reference's dense
  path rounds them to the dtype, an exact no-op in fp32; sums in another
  order give ~1e-6, grown through the layers).
- Three ``train_step``s of reduced stablelm-1.6b and qwen2-7b against the
  reference's ``make_train_step``: losses within 1e-5 relative, params
  within 1e-5, with AdamW's eps at 1e-6.  At the default 1e-8 a parameter
  whose gradient is analytically zero moves by about lr on rounding noise,
  whose sign the two packages need not share: the key bias (softmax ignores
  a shift of a row's scores) differs by 3e-5 after three steps, and so
  does an MLP weight or two whose gradient is ~1e-10.  At 1e-6 such noise
  moves nothing, and every other parameter's update is the same function
  of its gradient.
- ``tests/test_system.py``'s four training tests on the port's
  ``train_loop``, and its CLI.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokenPipeline as JaxPipeline
from repro.launch import steps as jax_steps
from repro.models import transformer as T
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainRunConfig, train_loop
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultInjector

ATTENTION_ARCHS = ("chatglm3-6b", "qwen2-7b", "stablelm-1.6b",
                   "starcoder2-3b", "whisper-small", "dbrx-132b",
                   "llama4-maverick-400b-a17b", "phi-3-vision-4.2b")
# the ten: the two recurrent configs train through the scans' backward
TRAINED_ARCHS = ATTENTION_ARCHS + ("recurrentgemma-2b", "falcon-mamba-7b")
# leaves that are 1 or 0 at init (norm scales, biases; the RG-LRU's gate
# biases and both conv biases, which only the recurrent configs have)
PERTURBED = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_i", "conv_b")
GRAD_RTOL = 1e-4


def _setup(arch, seed=0):
    """(reference params, reference cfg, port model (trainable), port cfg)
    on equal weights."""
    jcfg = dataclasses.replace(ref_get_reduced(arch), param_dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(np.asarray,
                             T.init_params(jcfg, jax.random.PRNGKey(seed)))

    def perturb(path, a):
        if path[-1].key in PERTURBED:
            return (a.astype(np.float32)
                    + rng.normal(0.0, 0.5, a.shape)).astype(a.dtype)
        return a

    np_params = jax.tree_util.tree_map_with_path(perturb, np_params)
    model = Transformer(tcfg, "cpu", trainable=True)
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), jcfg, model, tcfg


def _batch(cfg, B=2, S=16, seed=1, mask=True):
    """numpy batch: tokens, labels, a loss mask, and image embeddings or
    frames (bf16-rounded as the reference's train loop makes them)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    if cfg.img_tokens:
        b["img_embeds"] = rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_loss_and_grads_match_reference(arch):
    params, jcfg, model, tcfg = _setup(arch)
    nb = _batch(tcfg)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: T.loss_fn(p, jcfg, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, parts = loss_fn(model, {k: torch.from_numpy(v)
                                  for k, v in nb.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(parts["aux"].item(), float(ref_aux["aux"]),
                               rtol=1e-5, atol=1e-7)
    grads = _leaves(params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, tcfg))
    want = _leaves(ref_grads)
    assert sorted(grads) == sorted(want)
    errs = {n: _rel_rms(grads[n], want[n]) for n in want
            if np.any(want[n])}
    bad = {n: e for n, e in errs.items() if not e <= GRAD_RTOL}
    assert not bad, bad
    # a leaf with a zero reference gradient is zero here too
    for n in want:
        if not np.any(want[n]):
            assert not np.any(grads[n]), n


def test_moe_forward_returns_the_summed_aux_loss():
    _, _, model, tcfg = _setup("dbrx-132b")
    toks = torch.from_numpy(_batch(tcfg)["tokens"])
    logits, aux = model(toks, return_aux=True)
    assert torch.equal(logits, model(toks))
    x = model._embed(toks, None)
    want = torch.zeros(())
    for layer in model.layers:
        x, a = layer.run(x)
        want = want + (0.0 if a is None else a)
    assert aux.item() == pytest.approx(want.item()) and aux.item() > 0


def test_models_are_frozen_unless_trainable():
    cfg = get_reduced("qwen2-7b")
    assert not any(p.requires_grad for p in
                   Transformer(cfg, "cpu").parameters())
    assert all(p.requires_grad for p in
               Transformer(cfg, "cpu", trainable=True).parameters())
    with pytest.raises(ValueError, match="frozen"):
        make_train_step(Transformer(cfg, "cpu"))


@pytest.mark.parametrize("arch,microbatches,compression", [
    ("stablelm-1.6b", 1, False), ("qwen2-7b", 1, False),
    ("qwen2-7b", 2, False)])
def test_train_steps_match_reference(arch, microbatches, compression):
    """Three steps from equal weights on the pipeline's batches: the
    losses, the AdamW step counter and every param (the reference decays
    its stacked layer leaves: norm scales and biases decay here too).  Not
    with the int8 compression: a gradient 1e-6 apart can round to another
    int8 step, so runs agree only to a quantum; the compressor itself is
    held bit-equal to the reference's in tests/test_torch_optim.py."""
    params, jcfg, model, tcfg = _setup(arch, seed=3)
    ref_step, ref_init = jax_steps.make_train_step(
        jcfg, JaxAdamWConfig(lr=1e-3, eps=1e-6, moment_dtype="float32"),
        microbatches=microbatches, grad_compression=compression)
    step, opt_init = make_train_step(
        model, AdamWConfig(lr=1e-3, eps=1e-6, moment_dtype="float32"),
        microbatches=microbatches, grad_compression=compression)
    ref_step = jax.jit(ref_step)
    ref_opt, opt = ref_init(params), opt_init()
    data = JaxPipeline(JaxDataConfig(vocab=tcfg.vocab, seq_len=16,
                                     global_batch=4, seed=7))
    for s in range(3):
        nb = data.global_batch_at(s)
        params, ref_opt, ref_m = ref_step(
            params, ref_opt, {k: jnp.asarray(v) for k, v in nb.items()})
        opt, m = step(opt, {k: torch.from_numpy(v) for k, v in nb.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-4)
    assert int(opt["adam"]["step"]) == int(ref_opt["adam"]["step"]) == 3
    got = _leaves(params_to_jax(model.state_dict(), tcfg))
    want = _leaves(params)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


# ---- tests/test_system.py's training tests, on the port -------------------

def _tiny_run(tmp_path, name, **kw):
    cfg = dataclasses.replace(get_reduced("stablelm-1.6b"),
                              param_dtype="float32")
    defaults = dict(cfg=cfg, steps=24, global_batch=4, seq_len=32, lr=2e-3,
                    save_every=8, log_every=100,
                    ckpt_dir=os.path.join(str(tmp_path), name),
                    device="cpu")
    defaults.update(kw)
    return TrainRunConfig(**defaults)


def test_training_learns(tmp_path):
    run = _tiny_run(tmp_path, "learn", steps=60, global_batch=8, seq_len=64,
                    lr=3e-3, ckpt_dir=None, log_every=20)
    out = train_loop(run, log=lambda *a: None)
    h = out["history"]["loss"]
    assert h[-1] < h[0] - 0.7, f"no learning: {h}"


def test_restart_equivalence_after_injected_failure(tmp_path):
    """A crash + restore run must produce the same final params as an
    uninterrupted run (checkpoint integrity + exactly-once data)."""
    out_a = train_loop(_tiny_run(tmp_path, "a"), log=lambda *a: None)
    inj = FaultInjector(fail_at_steps=[13])
    out_b = train_loop(_tiny_run(tmp_path, "b"), injector=inj,
                       log=lambda *a: None)
    assert out_b["restarts"] == 1
    assert inj.fired == [13]
    pa = out_a["state"]["model"].state_dict()
    pb = out_b["state"]["model"].state_dict()
    for n in pa:
        np.testing.assert_allclose(pa[n].numpy(), pb[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    # the checkpoints on disk are the reference's format: retention kept
    # the newest three of steps 7, 15 and 23
    assert sorted(os.listdir(tmp_path / "b")) == [
        "step_00000007", "step_00000015", "step_00000023"]
    with open(tmp_path / "b" / "step_00000023" / "manifest.json") as f:
        names = [m["name"] for m in json.load(f)["leaves"]]
    assert "params/segments/seg0/pos0/attn/wq" in names
    assert "opt/adam/mu/embed" in names and "opt/adam/step" in names


def test_grad_compression_training_still_learns(tmp_path):
    run = _tiny_run(tmp_path, "gc", steps=60, global_batch=8, seq_len=64,
                    lr=3e-3, grad_compression=True, ckpt_dir=None)
    out = train_loop(run, log=lambda *a: None)
    h = out["history"]["loss"]
    assert h[-1] < h[0] - 0.6, f"compressed run failed to learn: {h}"


def test_microbatched_matches_full_batch():
    cfg = dataclasses.replace(get_reduced("qwen2-7b"), param_dtype="float32")
    base = TrainRunConfig(cfg=cfg, steps=6, global_batch=8, seq_len=32,
                          lr=1e-3, log_every=1, device="cpu")
    out1 = train_loop(base, log=lambda *a: None)
    out2 = train_loop(dataclasses.replace(base, microbatches=4),
                      log=lambda *a: None)
    np.testing.assert_allclose(out1["history"]["loss"],
                               out2["history"]["loss"], rtol=2e-4, atol=2e-4)


def test_train_cli_on_cpu(capsys, tmp_path):
    summary = train_cli.main([
        "--arch", "qwen2-7b", "--reduced", "--device", "cpu", "--layers",
        "1", "--steps", "3", "--batch", "2", "--seq", "16", "--log-every",
        "1", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("done: 3 steps, 0 restarts")
    printed = json.loads(lines[-1])
    assert printed == summary
    assert summary["layers"] == 1 and summary["device"] == "cpu"
    assert len(summary["loss"]) == 3 and len(summary["step_ms"]) == 3
    assert summary["peak_mem_gb"] is None
    assert os.listdir(tmp_path) == ["step_00000002"]


def test_train_on_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(TrainRunConfig(cfg=get_reduced("qwen2-7b"), steps=1))

