"""The port's optimizer against the JAX reference on the CPU: AdamW
(``repro_torch.optim.adamw``) over several steps with fp32 and bf16 moments,
clipping, weight decay and both metrics; ``cosine_schedule``; and the
error-feedback int8 compression, bit for bit.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance for AdamW in fp32: 1e-6 relative, to each tensor's largest
magnitude (both compute every step in fp32; the global norm's reduction
may differ in the last bit, and so then does the clip factor, which an
element whose moment terms cancel shows as a larger relative difference).  bf16 moments and params: each
side rounds the same fp32 values to bf16, so they agree to one bf16 step
(2^-8 relative) where an fp32 last-bit difference crosses a rounding
boundary, and almost everywhere exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import grad_compress as jax_gc
from repro.optim import schedules as jax_sched
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_decompress_ef, cosine_schedule,
                               ef_state_init)
from repro_torch.optim import adamw as port_adamw

SHAPES = {"embed": (37, 16), "norm": (16,), "stack": (3, 16, 8),
          "bias": (8,)}
RTOL = 1e-6


def _tree(rng, scale=1.0):
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _t(tree, dtype=torch.float32):
    return {n: torch.from_numpy(a.copy()).to(dtype) for n, a in tree.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip,weight_decay,grad_scale", [
    (1.0, 0.1, 1.0),       # clipped: the global norm is ~12
    (100.0, 0.1, 1.0),     # not clipped
    (0.0, 0.0, 0.1),       # clipping and decay off
])
def test_adamw_matches_reference_over_steps(moment_dtype, grad_clip,
                                            weight_decay, grad_scale):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg_kw = dict(lr=1e-2, grad_clip=grad_clip, weight_decay=weight_decay,
                  moment_dtype=moment_dtype)
    jcfg = jax_adamw.AdamWConfig(**cfg_kw)
    tcfg = AdamWConfig(**cfg_kw)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jst = jax_adamw.adamw_init(jp, jcfg)
    tp = _t(params)
    tst = adamw_init(tp, tcfg)
    assert tst["mu"]["embed"].dtype == (torch.float32 if moment_dtype ==
                                        "float32" else torch.bfloat16)
    for step in range(4):
        grads = _tree(rng, grad_scale)
        jp, jst, jm = jax_adamw.adamw_update(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, jst, jcfg,
            lr_scale=0.5)
        _, tst, tm = adamw_update(tp, _t(grads), tst, tcfg, lr_scale=0.5)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        assert tm["lr"] == pytest.approx(float(jm["lr"]))
        rel = RTOL if moment_dtype == "float32" else 2 ** -8
        for n in SHAPES:
            if moment_dtype == "float32":
                _close(_np(tp[n]), np.asarray(jp[n]), RTOL, n)
            else:     # a moment one bf16 step apart moves its update by
                np.testing.assert_allclose(   # 2^-8 of lr at most
                    _np(tp[n]), np.asarray(jp[n]), rtol=RTOL,
                    atol=2 * 2 ** -8 * tcfg.lr * 0.5, err_msg=n)
            for key in ("mu", "nu"):
                _close(_np(tst[key][n]),
                       np.asarray(jst[key][n].astype(jnp.float32)), rel,
                       f"{key} {n}")


def test_adamw_bf16_params_are_cast_back():
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng)
    cfg_kw = dict(lr=1e-2)
    jp = {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in params.items()}
    tp = _t(params, torch.bfloat16)
    jp, _, _ = jax_adamw.adamw_update(
        jp, {n: jnp.asarray(g) for n, g in grads.items()},
        jax_adamw.adamw_init(jp, jax_adamw.AdamWConfig(**cfg_kw)),
        jax_adamw.AdamWConfig(**cfg_kw))
    adamw_update(tp, _t(grads), adamw_init(tp, AdamWConfig(**cfg_kw)),
                 AdamWConfig(**cfg_kw))
    for n in SHAPES:
        assert tp[n].dtype == torch.bfloat16
        _close(_np(tp[n]), np.asarray(jp[n].astype(jnp.float32)), 2 ** -8,
               n)


def test_adamw_decays_only_matrices_by_default_and_by_mask():
    """Weight decay: ndim >= 2 by default (the reference's rule on its own
    leaves); ``decay`` overrides it per tensor, as the train step does for
    the reference's stacked layer leaves."""
    p = {"m": torch.ones(2, 2), "v": torch.ones(2)}
    g = {n: torch.zeros_like(t) for n, t in p.items()}
    cfg = AdamWConfig(lr=0.5, weight_decay=0.1)
    adamw_update(p, g, adamw_init(p, cfg), cfg)
    assert torch.all(p["m"] == 1 - 0.5 * 0.1) and torch.all(p["v"] == 1)
    p = {"m": torch.ones(2, 2), "v": torch.ones(2)}
    adamw_update(p, g, adamw_init(p, cfg), cfg,
                 decay={"m": False, "v": True})
    assert torch.all(p["m"] == 1) and torch.all(p["v"] == 1 - 0.5 * 0.1)


def test_adamw_chunks_large_tensors_without_changing_the_result(monkeypatch):
    rng = np.random.default_rng(2)
    params, grads = _tree(rng), _tree(rng)
    cfg = AdamWConfig(lr=1e-2)
    whole = _t(params)
    adamw_update(whole, _t(grads), adamw_init(whole, cfg), cfg)
    monkeypatch.setattr(port_adamw, "CHUNK", 7)
    chunked = _t(params)
    st = adamw_init(chunked, cfg)
    adamw_update(chunked, _t(grads), st, cfg)
    for n in SHAPES:
        assert torch.equal(whole[n], chunked[n]), n


@pytest.mark.parametrize("kw", [dict(), dict(warmup=10, total=50),
                                dict(warmup=0, total=20, min_ratio=0.0)])
def test_cosine_schedule_matches_reference(kw):
    for step in (0, 1, 5, 10, 11, 30, 49, 50, 80):
        want = float(jax_sched.cosine_schedule(jnp.int32(step), **kw))
        got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                    **kw))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), step
        assert float(cosine_schedule(step, **kw)) == pytest.approx(
            want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_ef_compression_bit_equal(scale):
    """q, its scale and the residual, bit for bit, over three rounds of
    error feedback (round-half-to-even on both sides); bf16 grads come back
    as bf16."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    jef = jax_gc.ef_state_init({n: jnp.asarray(a) for n, a in params.items()})
    tef = ef_state_init(_t(params))
    for _ in range(3):
        grads = _tree(rng, scale)
        # exact halves: x / scale lands on .5 for some entries
        grads["bias"][:4] = np.float32([0.5, -1.5, 2.5, 127.0])
        jd, jef = jax_gc.compress_decompress_ef(
            {n: jnp.asarray(g) for n, g in grads.items()}, jef)
        td, tef = compress_decompress_ef(_t(grads), tef)
        for n in SHAPES:
            assert np.array_equal(td[n].numpy(), np.asarray(jd[n])), n
            assert np.array_equal(tef[n].numpy(), np.asarray(jef[n])), n
        for n, g in grads.items():
            jq, js = jax_gc._quantize(jnp.asarray(g))
            from repro_torch.optim.grad_compress import _quantize
            tq, ts = _quantize(torch.from_numpy(g))
            assert np.array_equal(tq.numpy(), np.asarray(jq))
            assert np.float32(ts.item()) == np.float32(js)
    bf = {n: t.to(torch.bfloat16) for n, t in _t(_tree(rng)).items()}
    d, _ = compress_decompress_ef(bf, ef_state_init(bf))
    assert all(t.dtype == torch.bfloat16 for t in d.values())
