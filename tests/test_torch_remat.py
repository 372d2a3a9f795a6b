"""``remat`` in the port (``models/remat.py``) on the CPU, fp32.

- ``"full"`` and ``"selective"`` against ``"none"`` on all ten reduced
  configs: the loss, the MoE aux loss and every gradient leaf equal bit
  for bit (a recompute reruns the same operations on the same inputs).
- The port against the reference with the same ``remat`` (``jax.grad`` of
  the reference's ``loss_fn``, whose ``_remat_wrap`` wraps each scan body
  in ``jax.checkpoint``) on equal weights and batch, by
  ``tests/test_torch_train.py``'s tolerances: the loss within 1e-5
  relative, each gradient leaf within ``GRAD_RTOL``.
- What each policy recomputes, counted in ``aten.mm`` calls made by the
  backward: ``"full"`` every product of the wrapped groups once more,
  ``"selective"`` only the MoE experts' products (batched in the
  reference, saved nowhere).
- The groups are the reference's scan bodies: one per repeat of each
  segment's pattern.
- Serving ignores ``remat``: a frozen model's forward, the prefill and the
  decode steps give the same logits as under ``"none"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs import get_config as ref_get_config
from repro.models import transformer as T
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_to_jax
from repro_torch.launch.serve import generate
from repro_torch.models import remat
from repro_torch.models.transformer import (Transformer, check_ported,
                                            layer_groups, loss_fn)
from tests.test_torch_train import (GRAD_RTOL, _batch, _leaves, _rel_rms,
                                    _setup)

POLICIES = ("full", "selective")
# the reference comparison, each policy on three configs: an attention, a
# hybrid and an encoder-decoder one under full; an ssm, a MoE and a chunked
# MoE one under selective (whose policy the MoE experts test)
REFERENCE_CASES = (("qwen2-7b", "full"), ("recurrentgemma-2b", "full"),
                   ("whisper-small", "full"),
                   ("falcon-mamba-7b", "selective"),
                   ("dbrx-132b", "selective"),
                   ("llama4-maverick-400b-a17b", "selective"))


def _model(arch, policy, trainable=True):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32",
                              remat=policy)
    return Transformer(cfg, "cpu", seed=0, trainable=trainable)


def _torch_batch(cfg):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}


def _loss_and_grads(model, batch):
    loss, parts = loss_fn(model, batch)
    loss.backward()
    return loss.detach(), parts["aux"].detach(), {
        n: p.grad for n, p in model.named_parameters()}


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` calls, and those inside ``batched_products``."""

    def __init__(self):
        super().__init__()
        self.mm = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
            self.batched += remat._batched > 0
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gives_the_bits_of_none(arch, policy):
    base = _model(arch, "none")
    model = _model(arch, policy)
    batch = _torch_batch(base.cfg)
    want = _loss_and_grads(base, batch)
    got = _loss_and_grads(model, batch)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert sorted(got[2]) == sorted(want[2])
    for name, g in want[2].items():
        assert g is not None, name
        assert torch.equal(got[2][name], g), name


@pytest.mark.parametrize("arch,policy", REFERENCE_CASES)
def test_remat_matches_reference(arch, policy):
    params, jcfg, base, tcfg = _setup(arch)
    jcfg = dataclasses.replace(jcfg, remat=policy)
    tcfg = dataclasses.replace(tcfg, remat=policy)
    model = Transformer(tcfg, "cpu", trainable=True)
    model.load_state_dict(base.state_dict())
    nb = _batch(tcfg)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: T.loss_fn(p, jcfg, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, aux, grads = _loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(ref_aux["aux"]), rtol=1e-5,
                               atol=1e-7)
    got = _leaves(params_to_jax(grads, tcfg))
    want = _leaves(ref_grads)
    assert sorted(got) == sorted(want)
    bad = {n: e for n in want if np.any(want[n])
           for e in [_rel_rms(got[n], want[n])] if not e <= GRAD_RTOL}
    assert not bad, bad
    for n in want:
        if not np.any(want[n]):
            assert not np.any(got[n]), n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_each_policy_recomputes_what_the_reference_does(arch):
    """The backward's extra products: ``full`` every product inside the
    groups (all the forward's but the unembedding and ``img_proj``),
    ``selective`` the MoE experts' only.  Counted without the checkpoint's
    early stop, which ends a recompute once its last saved tensor is
    packed: autograd packs a product's inputs before the product runs, so
    a group ending in a product skips that one."""
    counts = {}
    for policy in ("none",) + POLICIES:
        model = _model(arch, policy)
        batch = _torch_batch(model.cfg)
        fwd, bwd = _CountMM(), _CountMM()
        with fwd, set_checkpoint_early_stop(False):
            loss = loss_fn(model, batch)[0]
        with bwd:
            loss.backward()
        counts[policy] = (fwd, bwd)
    fwd = counts["none"][0]
    outside = 1 + bool(model.cfg.img_tokens)
    extra = {p: counts[p][1].mm - counts["none"][1].mm for p in POLICIES}
    assert extra == {"full": fwd.mm - outside, "selective": fwd.batched}
    assert (fwd.batched > 0) == bool(model.cfg.n_experts)
    assert all(counts[p][0].mm == fwd.mm for p in POLICIES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_groups_are_the_reference_scan_bodies(arch):
    cfg = get_config(arch)
    want, i = [], 0
    for pattern, reps in T.segments(ref_get_config(arch)):
        for _ in range(reps):
            want.append(list(range(i, i + len(pattern))))
            i += len(pattern)
    assert [list(g) for g in layer_groups(cfg)] == want
    assert i == cfg.n_layers


def test_groups_of_the_named_configs():
    """recurrentgemma-2b: 3-layer patterns and the remainder; llama4:
    ``global_every`` layers; qwen2-7b and dbrx-132b: one layer each."""
    sizes = {a: [len(g) for g in layer_groups(get_config(a))]
             for a in ("recurrentgemma-2b", "llama4-maverick-400b-a17b",
                       "qwen2-7b", "dbrx-132b")}
    assert sizes["recurrentgemma-2b"] == [3] * 8 + [2]
    assert sizes["llama4-maverick-400b-a17b"] == [4] * 12
    assert sizes["qwen2-7b"] == [1] * 28
    assert sizes["dbrx-132b"] == [1] * 40


def test_check_ported_accepts_remat():
    cfg = get_reduced("qwen2-7b")
    for policy in ("none",) + POLICIES:
        check_ported(dataclasses.replace(cfg, remat=policy))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_ignores_remat(arch, policy):
    base = _model(arch, "none", trainable=False)
    model = _model(arch, policy, trainable=False)
    cfg = base.cfg
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6)))
    extra = {}
    if cfg.img_tokens:
        extra["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.img_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    # a frozen model's forward under grad mode, and generate
    assert torch.equal(model(prompts, **extra), base(prompts, **extra))
    got, want = (generate(m, prompts, 4, **extra) for m in (model, base))
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits, want.logits)


def test_serving_under_no_grad_wraps_nothing():
    """Under ``torch.no_grad()`` a trainable model's forward runs no
    checkpoint: the same logits, and no recompute to save tensors for."""
    base = _model("qwen2-7b", "none")
    model = _model("qwen2-7b", "full")
    toks = _torch_batch(base.cfg)["tokens"]
    with torch.no_grad():
        out = model(toks)
        assert torch.equal(out, base(toks))
    assert not out.requires_grad
