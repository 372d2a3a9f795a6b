"""The training path's kernels on the CPU: the plain versions of the two
backward kernels (``attention_bwd_ref``, ``rmsnorm_bwd_ref``) against
``torch.autograd.grad`` of the port's forward plain versions and against
``jax.grad`` of the reference's (``repro.kernels.flash_attention.ref``,
``repro.models.common.rmsnorm``), at every mask and head_dim the backward
kernel takes, windows and head_dim 256 included; the log-sum-exp against
``logsumexp``; the wrappers' routing under autograd (the plan, what
raises); and ``refuse_grad``, left to the RG-LRU's interface entry.  The CUDA kernels themselves are held to these plain versions on
the card by ``chip_smoke.py``.

Tolerance: fp32 throughout, 2e-5 absolute and relative (tests/
test_kernels.py:15 of the reference): both sides compute in fp32 and
differ by summation order only.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models.common import rmsnorm as jax_rmsnorm
from repro_torch.kernels import _grad
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

TOL = 2e-5
# (B, Sq, Skv, Hq, Hkv, D, causal, chunk): causal, chunk and unmasked with
# Sq != Skv, ragged lengths, G 1, 2, 4, 7 and 12, every head_dim of the
# backward kernel
CASES = [
    (2, 37, 37, 4, 2, 16, True, 0),
    (1, 70, 70, 12, 1, 32, True, 0),
    (2, 50, 50, 4, 4, 64, True, 16),
    (1, 33, 80, 7, 1, 96, False, 0),
    (1, 65, 65, 14, 2, 128, True, 0),
    (2, 40, 40, 8, 2, 64, False, 0),
    (1, 90, 90, 4, 1, 32, True, 30),
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_bwd_ref_matches_autograd_and_jax_grad(case):
    B, Sq, Skv, Hq, Hkv, D, causal, chunk = case
    rng = np.random.default_rng(sum(case))
    qn, kn, vn = _rand(rng, B, Sq, Hq, D), _rand(rng, B, Skv, Hkv, D), \
        _rand(rng, B, Skv, Hkv, D)
    don = _rand(rng, B, Sq, Hq, D)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    do = torch.from_numpy(don)
    o, lse = attention_ref(q, k, v, causal=causal, chunk=chunk,
                           return_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                            lse.detach(), do, causal=causal, chunk=chunk)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, name)

    # jax.grad of the reference's oracle (head-major layout)
    def f(qj, kj, vj):
        out = jax_attention(qj, kj, vj, causal=causal, chunk=chunk)
        return jnp.sum(out * jnp.asarray(don.transpose(0, 2, 1, 3)))

    jg = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (qn, kn, vn)))
    for name, g, w in zip(("dq", "dk", "dv"), got, jg):
        _close(g, np.asarray(w).transpose(0, 2, 1, 3), name)
    # the forward and its log-sum-exp: the reference's output, and
    # logsumexp of the scaled, masked scores
    _close(o.detach(), np.asarray(jax_attention(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (qn, kn, vn)),
        causal=causal, chunk=chunk)).transpose(0, 2, 1, 3))
    G = Hq // Hkv
    s = torch.einsum("bqhd,bkhd->bhqk", q.detach(),
                     k.detach().repeat_interleave(G, 2)) / math.sqrt(D)
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Skv)[None]
    ok = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if chunk:
        ok &= kp // chunk == qp // chunk
    _close(lse, torch.logsumexp(s.masked_fill(~ok, -torch.inf), -1))


# (B, Sq, Skv, Hq, Hkv, D, causal, window, chunk): recurrentgemma-2b's
# local attention (MQA 10:1, D 256, causal window) at a reduced length, its
# reduced config's D 16 window 8, a window at D 64 with Sq != Skv unmasked
# otherwise, and a window beside a chunk
WINDOW_CASES = [
    (1, 70, 70, 10, 1, 256, True, 24, 0),
    (2, 37, 37, 4, 1, 16, True, 8, 0),
    (1, 40, 56, 4, 2, 64, False, 17, 0),
    (1, 66, 66, 4, 2, 128, True, 20, 32),
]


@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_attention_bwd_ref_with_a_window_matches_autograd_and_jax_grad(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window, chunk = case
    rng = np.random.default_rng(sum(case))
    qn, kn, vn = _rand(rng, B, Sq, Hq, D), _rand(rng, B, Skv, Hkv, D), \
        _rand(rng, B, Skv, Hkv, D)
    don = _rand(rng, B, Sq, Hq, D)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    do = torch.from_numpy(don)
    kw = dict(causal=causal, window=window, chunk=chunk)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                            lse.detach(), do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)

    def f(qj, kj, vj):
        out = jax_attention(qj, kj, vj, **kw)
        return jnp.sum(out * jnp.asarray(don.transpose(0, 2, 1, 3)))

    jg = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (qn, kn, vn)))
    for name, g, w in zip(("dq", "dk", "dv"), got, jg):
        _close(g, np.asarray(w).transpose(0, 2, 1, 3), name)
    # the window moves something: without it the gradients differ
    other = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                              lse.detach(), do, causal=causal, chunk=chunk)
    assert not torch.allclose(other[1], got[1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D,dtype,window,want", [
    (256, torch.float32, 2048, "simt"), (256, torch.float32, 0, "simt"),
    (32, torch.bfloat16, 48, "simt"), (128, torch.float32, 64, "simt"),
    (64, torch.bfloat16, 0, "tc"), (16, torch.bfloat16, 8, "simt"),
    (96, torch.float32, 33, "simt"),
])
def test_plan_bwd_sends_a_window_or_head_dim_256_to_simt(D, dtype, window,
                                                         want):
    """In fp32 and at head_dim 16 and 32, a window or head_dim 256 goes to
    ``simt`` (bf16 at 64-256 goes to ``tc`` with or without one: below)."""
    assert flash_ops.plan_bwd(2, 4096, 4096, 10, 1, D, dtype) == want
    if want == "simt":
        with pytest.raises(ValueError, match="does not take"):
            flash_ops.plan_bwd(2, 4096, 4096, 10, 1, D, dtype, impl="tc")
    # under autograd a window and head_dim 256 are taken
    flash_ops.check_grad_call(D, 4096, window=window)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        flash_ops.check_grad_call(D, 4096, window=window, q_offset=1)


@pytest.mark.parametrize("D,window", [
    (256, 2048), (256, 0), (128, 64), (96, 33), (64, 100), (256, 40),
])
def test_plan_bwd_sends_bf16_windows_and_head_dim_256_to_tc(D, window):
    """bf16 at head_dim 64, 96, 128 and 256 plans ``tc`` with or without a
    window (recurrentgemma-2b's local attention: D 256, window 2048);
    ``simt`` can still be forced there."""
    assert flash_ops.plan_bwd(2, 4096, 4096, 10, 1, D,
                              torch.bfloat16) == "tc"
    assert flash_ops.plan_bwd(2, 4096, 4096, 10, 1, D, torch.bfloat16,
                              impl="simt") == "simt"
    flash_ops.check_grad_call(D, 4096, window=window)


def test_cpu_windowed_attention_under_autograd_takes_the_plain_version():
    """A windowed D 256 call on the CPU under autograd: the plain version,
    differentiated by autograd, equal to ``attention_bwd_ref``; no counter
    moves."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(_rand(rng, 1, 40, 10, 256)).requires_grad_()
    k, v = (torch.from_numpy(_rand(rng, 1, 40, 1, 256)).requires_grad_()
            for _ in range(2))
    n = (flash_ops.flash_attention.launches,
         flash_ops.flash_attention_bwd.launches)
    out = flash_ops.flash_attention(q, k, v, window=16)
    do = torch.from_numpy(_rand(rng, 1, 40, 10, 256))
    grads = torch.autograd.grad(out, (q, k, v), do)
    o, lse = attention_ref(q.detach(), k.detach(), v.detach(), window=16,
                           return_lse=True)
    want = flash_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                         o, lse, do, window=16)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(g, w, name)
    assert n == (flash_ops.flash_attention.launches,
                 flash_ops.flash_attention_bwd.launches)


def test_attention_bwd_ref_uses_the_rounded_output():
    """delta = rowsum(dO * O) over the O the forward returned: a bf16 O
    gives bf16 arithmetic's delta, not the fp32 one."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(_rand(rng, 1, 20, 2, 16))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = attention_ref(q, k, v, return_lse=True)
    assert o.dtype == torch.bfloat16
    got = attention_bwd_ref(q, k, v, o, lse, do)
    assert all(g.dtype == torch.bfloat16 for g in got)
    o32 = attention_ref(q.float(), k.float(), v.float())
    alt = attention_bwd_ref(q, k, v, o32, lse, do)
    assert not torch.equal(got[0], alt[0])


@pytest.mark.parametrize("rows,d", [(1, 16), (5, 48), (300, 64), (7, 4096)])
def test_rmsnorm_bwd_ref_matches_autograd_and_jax_grad(rows, d):
    rng = np.random.default_rng(rows + d)
    xn, dyn = _rand(rng, rows, d), _rand(rng, rows, d)
    wn = (1.0 + 0.1 * _rand(rng, d)).astype(np.float32)
    x, w = (torch.from_numpy(a).requires_grad_() for a in (xn, wn))
    dy = torch.from_numpy(dyn)
    want = torch.autograd.grad(rmsnorm_ref(x, w), (x, w), dy)
    got = rmsnorm_bwd_ref(x.detach(), w.detach(), dy)
    jg = jax.grad(lambda a, b: jnp.sum(jax_rmsnorm(b, a) * dyn),
                  argnums=(0, 1))(jnp.asarray(xn), jnp.asarray(wn))
    for name, g, a, b in zip(("dx", "dw"), got, want, jg):
        _close(g, a, name)
        _close(g, np.asarray(b), name)


def test_rmsnorm_bwd_ref_sums_dw_in_fp64():
    """dw: the fp32 terms dy * xhat summed in fp64, then rounded; bf16
    outputs in bf16."""
    rng = np.random.default_rng(9)
    n, d = 600, 8
    x, dy = torch.from_numpy(_rand(rng, n, d)), torch.from_numpy(
        _rand(rng, n, d))
    w = torch.ones(d)
    _, dw = rmsnorm_bwd_ref(x, w, dy)
    xhat = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    want = sum((dy[r] * xhat[r]).double() for r in range(n)).float()
    assert torch.equal(dw, want)
    dx, dwb = rmsnorm_bwd_ref(x.bfloat16(), w.bfloat16(), dy.bfloat16())
    assert dx.dtype == dwb.dtype == torch.bfloat16


def test_cpu_wrappers_take_the_plain_versions_under_autograd():
    """On the CPU the wrappers return the plain versions, which autograd
    differentiates; no kernel counter moves."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 12, 2, 16)).requires_grad_()
               for _ in range(3))
    n_fwd, n_bwd = flash_ops.flash_attention.launches, \
        flash_ops.flash_attention_bwd.launches
    out = flash_ops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    x = torch.from_numpy(_rand(rng, 3, 16)).requires_grad_()
    w = torch.ones(16, requires_grad=True)
    rms_ops.fused_rmsnorm(x, w).sum().backward()
    assert x.grad is not None and w.grad is not None
    assert (flash_ops.flash_attention.launches,
            flash_ops.flash_attention_bwd.launches) == (n_fwd, n_bwd)
    dq, dk, dv = flash_ops.flash_attention_bwd(
        q.detach(), k.detach(), v.detach(), *attention_ref(
            q.detach(), k.detach(), v.detach(), return_lse=True),
        torch.ones_like(q))
    assert dq.shape == q.shape and dk.shape == k.shape
    dx, dw = rms_ops.rmsnorm_bwd(x.detach(), w.detach(), torch.ones(3, 16))
    assert dx.shape == x.shape and dw.shape == w.shape


@pytest.mark.parametrize("Sq,D,dtype,want", [
    (1024, 128, torch.bfloat16, "tc_prefill"),
    (1024, 64, torch.bfloat16, "tc_prefill"),
    (1024, 96, torch.bfloat16, "tc_prefill"),
    (1024, 16, torch.bfloat16, "simt"),
    (1024, 128, torch.float32, "simt"),
    (1, 128, torch.bfloat16, "simt"),      # never a decode kernel
    (8, 64, torch.bfloat16, "simt"),
])
def test_plan_under_autograd_takes_a_prefill_kernel(Sq, D, dtype, want):
    assert flash_ops.plan(8, Sq, 28, 4, D, dtype, Sq, lse=True).impl == want
    if Sq <= flash_ops.DECODE_MAX_SQ:   # serving keeps its decode kernels
        assert flash_ops.plan(8, Sq, 28, 4, D, dtype, Sq).impl in \
            flash_ops.DECODE_IMPLS
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_ops.plan(8, 1, 28, 4, D, dtype, 64, impl="warp_decode",
                       lse=True)


def test_backward_kernel_covers_the_eight_attention_configs():
    """Every config of the ten with attention layers (all but
    falcon-mamba-7b), full and reduced: its head_dim is a backward kernel's
    and its masks pass the autograd guard; recurrentgemma-2b's windowed D
    256 layers plan ``tc`` (the reduced configs' D 16 and 32, ``simt``)."""
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_reduced(arch)):
            if not any(k.startswith("attn") for k in cfg.layer_kinds()):
                assert arch == "falcon-mamba-7b"
                continue
            D = cfg.resolved_head_dim
            assert D in flash_ops.BWD_HEAD_DIMS, arch
            flash_ops.check_grad_call(D, 64, window=cfg.attn_window)
            impl = flash_ops.plan_bwd(2, 64, 64, cfg.n_heads,
                                      cfg.n_kv_heads, D, torch.bfloat16)
            assert impl == ("tc" if D in flash_ops.BWD_TC_HEAD_DIMS
                            else "simt"), arch
            assert bool(cfg.attn_window) == (arch == "recurrentgemma-2b")


def test_refuse_grad_raises_only_under_grad_with_grad_inputs():
    a = torch.ones(2, requires_grad=True)
    b = torch.ones(2)
    with pytest.raises(NotImplementedError, match="rglru_scan.*no model"):
        _grad.refuse_grad("rglru_scan", b, a, None)
    _grad.refuse_grad("rglru_scan", b, None)
    with torch.no_grad():
        _grad.refuse_grad("rglru_scan", a)
